"""Hand-written Hopper kernels (``csrc/*.cu``) for the serving path, their
plain PyTorch versions and the dispatch the engine calls (:mod:`.ops`)."""
