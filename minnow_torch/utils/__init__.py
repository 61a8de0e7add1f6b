"""Config and name-index parsing, stage timing, and the CUDA device
(counterpart of ``minnow_tpu/utils``)."""
