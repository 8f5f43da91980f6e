"""Model configurations of the port (``repro.configs``'s counterpart)."""

from repro_torch.configs.registry import (ArchSpec, DryrunCase, SkipCell,
                                          TensorSpec, get_arch, list_archs,
                                          register)

__all__ = ["ArchSpec", "DryrunCase", "SkipCell", "TensorSpec", "get_arch",
           "list_archs", "register"]
