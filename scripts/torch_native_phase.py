"""chip_smoke.py's ``native`` phase alone, on the card: the operator
library and the C++ host built from the checkout, the native bundles
exported, every function answered by the host and held against
``Serving``; prints the phase's JSON line (and the card's name and
power limit first).

    python scripts/torch_native_phase.py [LABEL,LABEL,...]

The labels are keys of ``chip_smoke.HOST_EXPORTS`` (default: all).
Exits non-zero when a check of the phase fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("the native phase needs a CUDA device", file=sys.stderr)
        return 1
    from cliffordtpu_torch import random as trandom
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.kernels import build as kbuild
    from cliffordtpu_torch.kernels import native as knative
    from cliffordtpu_torch.native import build as nbuild
    from cliffordtpu_torch.nn import conv_vae, mlp_vae, vit_vae
    from cliffordtpu_torch.ops import rope

    exports = chip_smoke.HOST_EXPORTS
    if argv:
        labels = argv[0].split(",")
        unknown = set(labels) - set(exports)
        if unknown:
            print(f"unknown labels {sorted(unknown)}", file=sys.stderr)
            return 2
        exports = {k: v for k, v in exports.items() if k in labels}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        chip_smoke.native_phase(
            (serving, vit_vae, conv_vae, mlp_vae, trandom, rope, knative),
            ROOT, work, exports, chip_smoke.native_builds(kbuild, nbuild))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
