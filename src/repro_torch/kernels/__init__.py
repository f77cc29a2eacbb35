"""Hand-written CUDA kernels of the port, their plain versions, and the
dispatch between them (:mod:`repro_torch.kernels.ops`)."""
