"""API-surface snapshot of the port: the public names and signatures of
``repro_torch.api``, ``repro_torch.configs`` and ``repro_torch.launch``
are frozen in ``tests/data/torch_api_surface.txt``, as
``tests/test_api_surface.py`` freezes ``repro.api``'s, so that an
accidental change of the port's facade fails fast.

Intentional changes: regenerate the snapshot and commit it with the code:

    PYTHONPATH=src python tests/test_torch_api_surface.py --regen
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_api_surface import _diff, _render_module  # noqa: E402

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_api_surface.txt")

MODULES = ["repro_torch.api", "repro_torch.configs", "repro_torch.launch"]


def render_api_surface() -> str:
    lines = []
    for modname in MODULES:
        lines.extend(_render_module(modname))
    return "\n".join(lines) + "\n"


def test_torch_api_surface_matches_snapshot():
    with open(SNAPSHOT) as f:
        frozen = f.read()
    current = render_api_surface()
    assert current == frozen, (
        "the port's public API surface changed. If intentional, regenerate "
        "with\n    PYTHONPATH=src python tests/test_torch_api_surface.py "
        "--regen\nand commit the snapshot.\nDiff:\n"
        + "\n".join(_diff(frozen, current)))


if __name__ == "__main__":
    if "--regen" in sys.argv:
        os.makedirs(os.path.dirname(SNAPSHOT), exist_ok=True)
        with open(SNAPSHOT, "w") as f:
            f.write(render_api_surface())
        print(f"wrote {SNAPSHOT}")
    else:
        print(render_api_surface(), end="")
