"""Model configurations of the port (``repro.configs``'s counterpart)."""
