"""Fold the HR tail conv through the final pixel shuffle (exact rewrite);
numpy weight transforms (counterpart of the JAX package's
``ops/fold_tail.py``).

    tail(act(d2s(u)))  ==  d2s( tanh( conv5x5(act(u)) ) )

Weight mapping (torch pixel-shuffle indexing, ops/pixel_shuffle.py): for
output phase (i,j) and input phase (i',j') at pre-shuffle offset (p,q) in
[-2,2]:

    dy = 2p + i' - i ; dx = 2q + j' - j
    W'[p+2, q+2, c*4 + i'*2 + j', t*4 + i*2 + j] = K[dy+4, dx+4, c, t]
    (zero where |dy| > 4 or |dx| > 4)
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def fold_tail_kernel(kernel, bias):
    """(9,9,C,3) HR kernel -> (5,5,C*4,12) pre-shuffle kernel (+ bias)."""
    kh, kw, c_in, c_out = kernel.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"tail kernel must be square odd, got {kernel.shape}")
    r = 2  # shuffle factor folded through
    kp = (kh + r - 1) // r
    if kp % 2 == 0:
        kp += 1  # keep 'same' padding symmetric
    half = kh // 2
    ph = kp // 2
    k_np = np.asarray(kernel, np.float32)
    out = np.zeros((kp, kp, c_in * r * r, c_out * r * r), np.float32)
    for i in range(r):          # output phase rows
        for j in range(r):      # output phase cols
            for p in range(-ph, ph + 1):
                for q in range(-ph, ph + 1):
                    for ip in range(r):   # input phase rows
                        for jp in range(r):
                            dy = r * p + ip - i
                            dx = r * q + jp - j
                            if abs(dy) > half or abs(dx) > half:
                                continue
                            out[p + ph, q + ph,
                                ip * r + jp::r * r,
                                i * r + j::r * r] = k_np[dy + half, dx + half]
    # channel interleave: input channel index c*4 + phase, output t*4 + phase
    bias_out = np.repeat(np.asarray(bias, np.float32), r * r)  # t*4 + phase
    return out, bias_out


def fold_tail_params(tail: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{'conv': {'kernel','bias'}} (HR tail) -> folded pre-shuffle params."""
    kernel, bias = fold_tail_kernel(tail["conv"]["kernel"], tail["conv"]["bias"])
    return {"conv": {"kernel": kernel, "bias": bias}}


def fold_tail_params_x4(tail: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HR tail folded through BOTH x2 shuffles of a x4 generator, as a 6x6
    stride-2 conv (padding 2, 48 outputs) on the pre-shuffle activations:

        d2s(tanh(conv5x5_same(u)))
          == d2s(d2s(tanh(conv3x3_same(s2d(u)))))            [fold again]
          == d2s(d2s(tanh(conv6x6_stride2_pad2(u))))         [absorb s2d]

    with W6[2p+i, 2q+j, c, :] = W3[p, q, c*4 + i*2 + j, :]. Returns params
    for a (6,6,4C,48) kernel; apply pixel_shuffle(., 2) twice afterwards.
    """
    k1, b1 = fold_tail_kernel(tail["conv"]["kernel"], tail["conv"]["bias"])
    k2, b2 = fold_tail_kernel(k1, b1)  # (3, 3, 16C, 48)
    c4 = k1.shape[2]
    k6 = np.zeros((6, 6, c4, k2.shape[3]), np.float32)
    for p in range(3):
        for q in range(3):
            for phase in range(4):
                ip, jp = divmod(phase, 2)
                k6[2 * p + ip, 2 * q + jp] = k2[p, q, phase::4, :]
    return {"conv": {"kernel": k6, "bias": b2}}
