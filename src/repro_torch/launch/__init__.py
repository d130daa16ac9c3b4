"""Launchers: ``python -m repro_torch.launch.train``, ``.serve``,
``.dryrun`` and ``.roofline``; ``mesh`` builds their device meshes."""
