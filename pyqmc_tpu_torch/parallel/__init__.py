"""Walker data parallelism over a torch.distributed process group
(counterpart of pyqmc_tpu/parallel/)."""
