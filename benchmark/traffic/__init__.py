"""Traffic: the request generator and the inputs it sends, from a seed."""
