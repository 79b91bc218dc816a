"""The film fold of a ray batch: ``film_fold`` (port of tpurt's frame
pass fold, tpurt/render.py:167-170 and :332-335, to
``csrc/film_fold.cu``).

A batch traces c samples of ``block`` pixels, sample-major: row
k * block + i holds sample k of the block's pixel i. The fold adds the
c samples of each pixel, in sample order, into its row of the film:
acc[p0 + i] += rad[i] + rad[block + i] + ... for m = min(block, n - p0)
rows of an n-row film. p0 is 0, or, for the frame graph
(kernels/frame_graph.py), read on the device from the frame's state
(state[0], the batch's cursor) when the kernel runs.
"""

from __future__ import annotations

import torch

from . import _build


def film_fold_plain(acc, rad, c: int, block: int, state=None):
    """Plain PyTorch version, in place on acc (n, 3): on rows [p0, p0 + m),
    p0 = state[0] if state is given else 0, m = min(block, n - p0), the
    sample planes summed one after the other from plane 0, then added to
    acc."""
    p0 = 0 if state is None else int(state[0])
    m = min(block, acc.shape[0] - p0)
    part = rad[:m]
    for k in range(1, c):
        part = part + rad[k * block:k * block + m]
    acc[p0:p0 + m] += part
    return acc


def film_fold(acc, rad, c: int, block: int, state=None):
    """Fold rad (c * block, 3) into acc (n, 3), in place on acc's device:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (or an error). Without ``state`` the fold covers all n <= block rows;
    with it (a (>= 1,) int64 tensor, p0 first) the rows at the cursor.
    Returns acc."""
    if acc.device.type == "cpu":
        return film_fold_plain(acc, rad, c, block, state)
    dev = _build.cuda_device("film_fold", acc)
    n = acc.shape[0]
    if state is None and n > block:
        raise ValueError(f"film_fold: {n} film rows, more than the block "
                         f"of {block}")
    _build.check("acc", acc, (n, 3), torch.float32, dev)
    _build.check("rad", rad, (c * block, 3), torch.float32, dev)
    if state is not None:
        _build.check("state", state, (state.shape[0],), torch.int64, dev)
    _build.launch("tt_film_fold", dev, rad, acc, state, c, block, n)
    _build.count("film_fold")
    return acc
