"""PyTorch/CUDA port of the CRouting ANNS system (the JAX package
``repro`` is the reference).  Entry point: ``repro_torch.core.index.AnnIndex``."""
