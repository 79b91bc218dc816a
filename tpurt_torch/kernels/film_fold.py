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

Given ``step`` (a frame state) and ``n_pad``, the fold also ends the
batch: its last block to finish steps that state's cursor to the next
batch (``loop_ctl.frame_advance_plain`` in the plain version), so a
frame graph's batch ends with the fold and no node of its own for the
cursor.
"""

from __future__ import annotations

import torch

from . import _build
from .loop_ctl import MAX_LOOP_BLOCKS, STATE_SLOTS, frame_advance_plain

FLOATS_PER_BLOCK = 256 * 8   # film floats a block of the kernel folds


def film_fold_plain(acc, rad, c: int, block: int, state=None, step=None,
                    n_pad: int = 0):
    """Plain PyTorch version, in place on acc (n, 3): on rows [p0, p0 + m),
    p0 = state[0] if state is given else 0, m = min(block, n - p0), the
    sample planes summed one after the other from plane 0, then added to
    acc; then, given step, frame_advance_plain(step, block, n_pad, c)."""
    p0 = 0 if state is None else int(state[0])
    m = min(block, acc.shape[0] - p0)
    part = rad[:m]
    for k in range(1, c):
        part = part + rad[k * block:k * block + m]
    acc[p0:p0 + m] += part
    if step is not None:
        frame_advance_plain(step, block, n_pad, c)
    return acc


def film_fold(acc, rad, c: int, block: int, state=None, step=None,
              n_pad: int = 0):
    """Fold rad (c * block, 3) into acc (n, 3), in place on acc's device:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (or an error). Without ``state`` the fold covers all n <= block rows;
    with it (a (>= 1,) int64 tensor, p0 first) the rows at the cursor.
    ``step``, if given, is a frame state (loop_ctl.STATE_SLOTS int64,
    may be ``state`` itself) whose cursor the kernel's last block steps
    over a padded pixel list of n_pad rows. Returns acc."""
    if acc.device.type == "cpu":
        return film_fold_plain(acc, rad, c, block, state, step, n_pad)
    dev = _build.cuda_device("film_fold", acc)
    n = acc.shape[0]
    if state is None and n > block:
        raise ValueError(f"film_fold: {n} film rows, more than the block "
                         f"of {block}")
    _build.check("acc", acc, (n, 3), torch.float32, dev)
    _build.check("rad", rad, (c * block, 3), torch.float32, dev)
    if state is not None:
        _build.check("state", state, (state.shape[0],), torch.int64, dev)
    if step is not None:
        _build.check("step", step, (STATE_SLOTS,), torch.int64, dev)
        blocks = -(-3 * min(n, block) // FLOATS_PER_BLOCK)
        if c <= 0 or block <= 0 or n_pad <= 0 or n_pad % block:
            raise ValueError(f"film_fold: a step needs c, block > 0 and "
                             f"whole blocks, not c {c}, block {block}, "
                             f"n_pad {n_pad}")
        if blocks > MAX_LOOP_BLOCKS:
            raise ValueError(f"film_fold: {blocks} blocks, more than the "
                             f"done counter's {MAX_LOOP_BLOCKS}")
    _build.launch("tt_film_fold", dev, rad, acc, state, c, block, n, step,
                  n_pad)
    _build.count("film_fold")
    return acc
