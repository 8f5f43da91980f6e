"""Models of the port (``repro.models``'s counterpart): DeepFM
(``models/recsys``), the GNNs (``models/gnn``), the dense decoder-only
LMs (``models/transformer.py``) and the sharding plan they take
(``models/sharding.py``; only the null plan so far)."""
