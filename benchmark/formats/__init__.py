"""One workload module a file format: set-up, requests, the check and the control."""
