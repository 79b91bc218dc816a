"""The film fold of a ray batch: ``film_fold`` (port of tpurt's frame
pass fold, tpurt/render.py:167-170 and :332-335, to
``csrc/film_fold.cu``).

A batch traces c samples of ``block`` pixels, sample-major: row
k * block + i holds sample k of the block's pixel i. The fold adds the
c samples of each pixel, in sample order, into its row of the film:
acc[i] += rad[i] + rad[block + i] + ... for the film's m <= block rows.
"""

from __future__ import annotations

import torch

from . import _build


def film_fold_plain(acc, rad, c: int, block: int):
    """Plain PyTorch version, in place on acc (m, 3): the sample planes
    summed one after the other from plane 0, then added to acc."""
    m = acc.shape[0]
    part = rad[:m]
    for k in range(1, c):
        part = part + rad[k * block:k * block + m]
    acc += part
    return acc


def film_fold(acc, rad, c: int, block: int):
    """Fold rad (c * block, 3) into acc (m, 3), m <= block, in place on
    acc's device: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error). Returns acc."""
    if acc.device.type == "cpu":
        return film_fold_plain(acc, rad, c, block)
    dev = _build.cuda_device("film_fold", acc)
    m = acc.shape[0]
    if m > block:
        raise ValueError(f"film_fold: {m} film rows, more than the block "
                         f"of {block}")
    _build.check("acc", acc, (m, 3), torch.float32, dev)
    _build.check("rad", rad, (c * block, 3), torch.float32, dev)
    _build.launch("tt_film_fold", dev, rad, acc, c, block, m)
    _build.LAUNCHES["film_fold"] += 1
    return acc
