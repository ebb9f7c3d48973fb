"""A rank's rows of the global batch (port of
``cliffordtpu/parallel/data.py``).

Each rank loads the same data and takes its rows of every global batch:
the data-axis coordinate r of n holds rows r*B/n .. (r+1)*B/n, and
ranks that differ only on the "model" axis hold the same rows.  The
same range is the ``rows`` of the rank's latent draw.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def data_rank(mesh) -> int:
    return mesh.get_local_rank("data")


def global_batch_rows(mesh, batch: int) -> Tuple[int, int]:
    """(r0, r1): the rows of a global batch of ``batch`` that this rank
    holds; raises unless the data axis divides it."""
    n = mesh["data"].size()
    if batch % n:
        raise ValueError(f"a batch of {batch} is not divisible by the data "
                         f"axis ({n})")
    b = batch // n
    r = data_rank(mesh)
    return r * b, (r + 1) * b


def make_global_batch(mesh, local_batch) -> torch.Tensor:
    """This rank's rows (``local_batch``, numpy or a tensor) as float32 on
    its device: the counterpart of JAX's process-local assembly, where
    each rank keeps its own rows."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    return torch.as_tensor(np.asarray(local_batch) if not isinstance(
        local_batch, torch.Tensor) else local_batch, dtype=torch.float32,
        device=device)
