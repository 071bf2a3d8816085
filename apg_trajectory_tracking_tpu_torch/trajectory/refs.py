"""Array-backed reference windows and the projection onto a line
(counterparts of ``array_ref_window`` and ``project_to_line`` in the JAX
package's ``trajectory/refs.py``)."""

import torch


def array_ref_window(reference, ind, horizon):
    """Reference rows [ind+1, ind+horizon] with end-of-trajectory padding:
    past the end the position pins to the final point and the other
    columns are zero.

    Args:
        reference: (..., T, D) tensor; leading dims are a batch of
            references.
        ind: int current index.
        horizon: int.
    Returns:
        (..., horizon, D) window.
    """
    T = reference.shape[-2]
    idx = ind + 1 + torch.arange(horizon, device=reference.device)
    window = reference[..., torch.clamp(idx, max=T - 1), :]
    pad_row = torch.zeros_like(reference[..., -1:, :])
    pad_row[..., :3] = reference[..., -1:, :3]
    valid = (idx < T)[:, None]
    return torch.where(valid, window, pad_row)


def project_to_line(a, b, p):
    """Projection of ``p`` onto the line through ``a`` and ``b``; ``a`` when
    the two points coincide. Batched over leading dims of (..., 3) inputs."""
    ab = b - a
    denom = torch.sum(ab**2, dim=-1, keepdim=True)
    t = torch.sum((p - a) * ab, dim=-1, keepdim=True) / torch.where(
        denom == 0, 1.0, denom
    )
    return torch.where(denom == 0, a, a + t * ab)
