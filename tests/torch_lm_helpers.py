"""Plain torch forms of the LM's blocks, for tests on the CPU and on the
card (this module imports no JAX)."""

import numpy as np
import torch


def plain_attention(q, k, v, causal_offset, q_chunk):
    """The reference's ``_attn_block`` order on the port's per-head
    products: scores, ``/ sqrt(dh)`` in their dtype, ``where`` with the
    dtype's min, the float32 softmax cast back, the product with V."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    div = torch.tensor(np.sqrt(np.float32(dh))).to(q.device, q.dtype)
    out = []
    for st in range(0, S, q_chunk):
        qb = q[:, st:st + q_chunk].reshape(B, -1, Hkv, g, dh)
        Sq = qb.shape[1]
        qi = st + torch.arange(Sq, device=q.device)[:, None] + causal_offset
        mask = (torch.arange(T, device=q.device)[None, :] <= qi)[:, None, :]
        heads = []
        for h in range(Hkv):
            s = torch.bmm(qb[:, :, h].reshape(B, Sq * g, dh),
                          k[:, :, h].transpose(1, 2)).view(B, Sq, g, T)
            s = torch.where(mask, s / div, torch.finfo(s.dtype).min)
            w = torch.softmax(s.float(), dim=-1).to(q.dtype)
            heads.append(torch.bmm(w.view(B, Sq * g, T), v[:, :, h])
                         .view(B, Sq, g, dh))
        out.append(torch.stack(heads, 2).reshape(B, Sq, H, dh))
    return torch.cat(out, 1)
