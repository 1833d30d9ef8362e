"""Small utilities (counterpart of torchseg_tpu/utils/misc.py; the
reference's furnace/utils/pyt_utils.py helpers).

JAX's ``enable_compile_cache`` has no counterpart: nothing here is
compiled per run but the kernels, and their build is already cached by a
hash of the source (``ops/kernels/_build.py``).
"""

import os
from typing import List


def parse_devices(spec: str) -> List[int]:
    """'0-3' / '0,2,5' / '*' -> device index list (reference
    pyt_utils.py:82-106); '*' is every visible CUDA card."""
    if spec.strip() == "*":
        import torch

        return list(range(torch.cuda.device_count()))
    out = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def ensure_dir(path: str):
    os.makedirs(path, exist_ok=True)


def link_file(src: str, link: str):
    """Replace ``link`` with a symlink to ``src`` (reference
    pyt_utils.py:118-123, without the os.system shell-out)."""
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(src, link)


def extant_file(path: str) -> str:
    """argparse type: the file must exist (pyt_utils.py:109-116)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path
