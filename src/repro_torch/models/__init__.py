"""Models of the port (``repro.models``'s counterpart): so far the DeepFM
serving path of ``models/recsys`` and the MLP it needs from ``models/gnn``."""
