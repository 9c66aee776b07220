"""Launch entry points (``python -m repro_torch.launch.serve``) and the
host's meshes and rank processes (``launch.mesh``)."""
