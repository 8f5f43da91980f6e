"""Models of the port (``repro.models``'s counterpart): so far the DeepFM
serving path of ``models/recsys``, and from ``models/gnn`` the MLP it needs
and the ``GraphBatch`` container ``spectral/pe.py`` fills."""
