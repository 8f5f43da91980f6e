"""Launchers of the port (``repro.launch``'s counterpart): so far the LM
training driver, ``python -m repro_torch.launch.train``. The dry-run,
the mesh and the cost reports wait for ROADMAP A15 and A16."""
