"""K6's per-channel arithmetic, stated in the kernel's own order.

``k6_order_model`` computes what ``csrc/ms_deform_attn.cu`` computes for
each output channel, one f32 operation at a time in the kernel's order:
levels, then points, then the corners (y0, x0), (y0, x1), (y1, x0),
(y1, x1); each coefficient and each product or sum is one f32 multiply,
subtract or add (no fused multiply-add), a corner whose weight is 0 is
skipped, and the f32 sum is cast once to the value's dtype. On the card the
kernel must give the same bits (``tests/test_torch_kernels_cuda.py``); here
the model is held to the JAX gather core
(``mmor_tpu.ops.deformable_attention.ms_deform_attn``, jitted once a layout)
and to the port's plain version (``ops/deformable_attention.py``), both of
which sum in another order: within f32 max abs 1e-5, and in bf16 within
K6's phase-2 bound (rel_l2 1e-3: one rounding step where the two f32 sums
fall on either side of a rounding boundary).

JAX is imported inside the fixture that needs it, so the card tests can
import the model from this file without it.
"""

import numpy as np
import pytest
import torch

from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores


def k6_order_model(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """K6's output, (N, Lq, M*D) in the value's dtype, computed in the
    kernel's order on whatever device the operands lie on. value (N, S, M, D),
    sampling_locations (N, Lq, M, L, P, 2) f32 as (x, y), attention_weights
    (N, Lq, M, L, P) in the value's dtype."""
    n, _, m, d = value.shape
    _, lq, _, levels, points, _ = sampling_locations.shape
    dev = value.device
    v = value.float()
    loc = sampling_locations.float()
    attn = attention_weights.float()
    acc = torch.zeros(n, lq, m, d, dtype=torch.float32, device=dev)
    frames = torch.arange(n, device=dev)[:, None, None]
    heads = torch.arange(m, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def add(pixel, wgt):  # acc += wgt * value, skipped where wgt == 0
        corner = v[frames, pixel, heads]  # (N, Lq, M, D)
        wgt = wgt[..., None]
        return torch.where(wgt != 0, acc + wgt * corner, acc)

    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        hmax = torch.tensor(float(max(h - 2, 0)), device=dev)
        wmax = torch.tensor(float(max(w - 2, 0)), device=dev)
        for p in range(points):
            a = attn[:, :, :, lvl, p]
            x = loc[:, :, :, lvl, p, 0] * float(w) - 0.5
            y = loc[:, :, :, lvl, p, 1] * float(h) - 0.5
            x0 = torch.fmin(torch.fmax(torch.floor(x), zero), wmax)
            y0 = torch.fmin(torch.fmax(torch.floor(y), zero), hmax)
            wx0 = torch.fmax(1.0 - torch.abs(x - x0), zero)
            wx1 = torch.fmax(1.0 - torch.abs(x - (x0 + 1.0)), zero)
            ay0 = a * torch.fmax(1.0 - torch.abs(y - y0), zero)
            ay1 = a * torch.fmax(1.0 - torch.abs(y - (y0 + 1.0)), zero)
            p00 = start + y0.long() * w + x0.long()
            acc = add(p00, ay0 * wx0)
            if w > 1:
                acc = add(p00 + 1, ay0 * wx1)
            if h > 1:
                acc = add(p00 + w, ay1 * wx0)
                if w > 1:
                    acc = add(p00 + w + 1, ay1 * wx1)
        start += h * w
    return acc.reshape(n, lq, m * d).to(value.dtype)


SERVING_CUT = ((3, 5), (6, 10), (12, 20))  # 23x40, 46x80, 92x160 cut by 8
ONE_PIXEL = ((1, 1), (6, 10), (12, 20))  # a 1-pixel level in its place


def k6_operands(shapes, n=2, m=8, d=32, points=4, seed=0, spread=0.25, bf16=False):
    """Seeded numpy operands: a query at every pixel centre of every level
    (Lq = S, as the pixel decoder's), each point moved by uniform offsets of
    up to ``spread`` of the map (a share of the samples off the map),
    weights softmaxed over L x P; value and weights in f32, or rounded to
    bf16 with ``bf16``."""
    rng = np.random.default_rng(seed)
    levels = len(shapes)
    s = sum(h * w for h, w in shapes)
    refs = np.concatenate([
        np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h),
                 -1).reshape(-1, 2) for h, w in shapes]).astype(np.float32)
    off = rng.uniform(-spread, spread, (n, s, m, levels, points, 2)).astype(np.float32)
    loc = (refs[None, :, None, None, None, :] + off).astype(np.float32)
    logits = rng.standard_normal((n, s, m, levels * points)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    dtype = torch.bfloat16 if bf16 else torch.float32
    attn = attn.reshape(n, s, m, levels, points).astype(np.float32)
    return (torch.from_numpy(value).to(dtype), torch.from_numpy(loc),
            torch.from_numpy(attn).to(dtype))


@pytest.fixture(scope="module")
def jgather():
    import jax

    from mmor_tpu.ops.deformable_attention import ms_deform_attn as jms_deform_attn

    return jax.jit(jms_deform_attn, static_argnums=1)


def _jax(jgather, value, shapes, loc, attn):
    import jax.numpy as jnp

    out = jgather(jnp.asarray(value.float().numpy()), shapes, jnp.asarray(loc.numpy()),
                  jnp.asarray(attn.float().numpy()))
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("shapes", [SERVING_CUT, ONE_PIXEL], ids=["serving_cut", "one_pixel"])
def test_order_model_matches_jax_gather_core(jgather, shapes):
    value, loc, attn = k6_operands(shapes)
    off_map = ((loc < 0) | (loc > 1)).any(-1).float().mean()
    assert 0.05 < float(off_map) < 0.5  # the operands reach off the map
    got = k6_order_model(value, shapes, loc, attn)
    want = _jax(jgather, value, shapes, loc, attn)
    assert got.shape == want.shape == (2, value.shape[1], 8 * 32)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("shapes", [SERVING_CUT, ONE_PIXEL], ids=["serving_cut", "one_pixel"])
def test_order_model_matches_plain_version(shapes):
    value, loc, attn = k6_operands(shapes, seed=1)
    got = k6_order_model(value, shapes, loc, attn)
    want = ms_deform_attn(value, shapes, loc, attn)
    assert got.dtype == want.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5


def test_order_model_matches_plain_version_in_bf16():
    """bf16 value and weights: the model and the plain version round the
    same f32 sums once (summed in another order)."""
    value, loc, attn = k6_operands(SERVING_CUT, seed=2, bf16=True)
    got = k6_order_model(value, SERVING_CUT, loc, attn)
    want = ms_deform_attn(value, SERVING_CUT, loc, attn)
    assert got.dtype == want.dtype == torch.bfloat16
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    assert rel <= 1e-3


def test_order_model_takes_exact_samples_and_skips_off_map_corners():
    """A sample on a pixel centre with weight 1 gives that pixel's value; a
    point far off the map adds nothing, not even a NaN held in the value
    map (its corners weigh 0 and are skipped)."""
    shapes = ((4, 8), (2, 4))
    value, loc, attn = k6_operands(shapes, n=1, m=2, d=8, seed=3)
    value[0, 5] = float("nan")  # level 0's pixel (0, 5)
    loc[:] = torch.tensor([-3.0, 4.5])
    attn.zero_()
    attn[:, :, :, 0, 0] = 1.0
    row, col = 2, 5  # level 0's pixel (2, 5)
    loc[:, 1, :, 0, 0] = torch.tensor([(col + 0.5) / 8, (row + 0.5) / 4])
    got = k6_order_model(value, shapes, loc, attn).view(1, -1, 2, 8)
    assert torch.equal(got[:, 1], value[:, row * 8 + col])
    rest = got[:, [0, *range(2, got.shape[1])]]
    assert torch.equal(rest, torch.zeros_like(rest))
