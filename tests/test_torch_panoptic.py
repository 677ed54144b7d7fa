"""Parity of the PyTorch port's panoptic stack (DVIS++ online) with the JAX package.

Weights are made once with numpy for the flax parameter tree (its shapes
from ``jax.eval_shape`` of the flax init, which is cheap where a real flax
init of the tiny DVIS++ takes 30-90 s on a CPU), with the reference's
directional offset-bias grid in every ``sampling_offsets`` bias. They go to
the JAX modules as they are and to the port through
``mmor_tpu_torch.utils.convert_jax.convert_dvis``; inputs are seeded numpy
arrays. Everything is f32 on the CPU, where K6's wrapper takes its plain
version.

Tolerances:
- the deformable sampler against the JAX gather core and the Pallas kernel
  (interpret mode): max abs 1e-5 (f32 sums of 12 products in another order);
- ``jax.image.resize`` counterparts: max abs 1e-6;
- module outputs (ResNet-50, pixel decoder, mask decoder, tracker): rel_l2
  <= 1e-5; the mask decoder's attention-bias masks identical in every entry;
- a DVIS++ window step end to end: rel_l2 <= 1e-4;
- the two CLIs' ``evaluate_videos`` on the synthetic video: the same VPQ and
  STQ, with the panoptic maps compared pixel by pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmor_tpu.cli import eval_panoptic as jcli
from mmor_tpu.models import layers as jlayers
from mmor_tpu.models.meta_arch import DVISConfig as JDVISConfig
from mmor_tpu.models.meta_arch import DVISPlus as JDVISPlus
from mmor_tpu.models.segmenter import normalize_pixels as jnormalize
from mmor_tpu.ops.deformable_attention import ms_deform_attn as jms_deform_attn
from mmor_tpu.ops.deformable_sampler import ms_deform_attn_pallas
from mmor_tpu_torch.cli import eval_panoptic as tcli
from mmor_tpu_torch.models.meta_arch import DVISConfig, DVISPlus
from mmor_tpu_torch.models.pixel_decoder import resize_nearest
from mmor_tpu_torch.models.segmenter import normalize_pixels
from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn
from mmor_tpu_torch.ops.deformable_sampler import ms_deform_attn_sampler
from mmor_tpu_torch.utils.convert_jax import convert_dvis
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

# the JAX gather core, jitted: one compile a shape instead of eager dispatch
# of its many small ops (~2 s a shape on a CPU)
jgather = jax.jit(jms_deform_attn, static_argnums=1)

SAMPLER_TOL = 1e-5
RESIZE_TOL = 1e-6
F32_TOL = 1e-5
STEP_TOL = 1e-4
SIZE, FRAMES = 64, 3


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tt(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------- K6's plain version
def _grid_refs(shapes):
    refs = []
    for h, w in shapes:
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                             indexing="ij")
        refs.append(np.stack([xs.ravel(), ys.ravel()], -1))
    return np.concatenate(refs).astype(np.float32)


def _sampler_inputs(shapes, n, m, d, off_scale, seed, points=4):
    """Queries on the grid of every level (Lq = S), offsets uniform in
    +-off_scale (0.7 puts many samples off the map), softmaxed weights."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    levels = len(shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    off = rng.uniform(-off_scale, off_scale, (n, s, m, levels, points, 2))
    loc = (_grid_refs(shapes)[None, :, None, None, None, :] + off).astype(np.float32)
    logits = rng.standard_normal((n, s, m, levels * points))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.reshape(n, s, m, levels, points).astype(np.float32)


@pytest.mark.parametrize("off_scale", [0.03, 0.7])
@pytest.mark.parametrize("m,d", [(2, 4), (8, 32)])
def test_ms_deform_attn_matches_jax_gather(m, d, off_scale):
    shapes = ((4, 5), (8, 10), (16, 20))
    value, loc, attn = _sampler_inputs(shapes, 2, m, d, off_scale, seed=m * 100 + d)
    want = np.asarray(jgather(jnp.asarray(value), shapes, jnp.asarray(loc),
                                      jnp.asarray(attn)))
    got = ms_deform_attn(tt(value), shapes, tt(loc), tt(attn))
    assert got.shape == (2, value.shape[1], m * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_TOL, rtol=0)
    # the K6 wrapper takes exactly the plain version for CPU tensors
    wrapped = ms_deform_attn_sampler(tt(value), shapes, tt(loc), tt(attn))
    assert torch.equal(wrapped, got)


def test_ms_deform_attn_bf16_keeps_f32_corner_weights():
    """A deliberate difference (ROADMAP Queue 3): with a bf16 value the JAX
    gather core rounds each corner's hat weight to bf16 before its product
    (``deformable_attention.py:81-86``); the port, and K6, keep every
    weight and product in f32 and round the sum once. So the port is the
    closer of the two to the exact f32 result on the same bf16 values, and
    within one bf16 rounding of it."""
    shapes = ((8, 10), (16, 20))
    value, loc, attn = _sampler_inputs(shapes, 1, 4, 32, 0.1, seed=11)
    bf = np.asarray(jnp.asarray(value).astype(jnp.bfloat16).astype(jnp.float32))
    exact = np.asarray(jgather(jnp.asarray(bf), shapes, jnp.asarray(loc),
                                       jnp.asarray(attn)))
    jax_bf16 = np.asarray(jgather(jnp.asarray(bf).astype(jnp.bfloat16), shapes,
                                          jnp.asarray(loc), jnp.asarray(attn)),
                          dtype=np.float32)
    port = ms_deform_attn(tt(bf).bfloat16(), shapes, tt(loc), tt(attn)).float()
    assert rel_l2(port, exact) < rel_l2(jax_bf16, exact)
    assert rel_l2(port, exact) <= 2.0 ** -9


def test_ms_deform_attn_one_pixel_level_matches_jax_gather():
    """Degenerate levels (1 x W, H x 1, 1 x 1) shrink the window; against
    the gather core only (the Pallas kernel's windows need 2-D levels)."""
    shapes = ((1, 6), (5, 1), (1, 1), (4, 4))
    value, loc, attn = _sampler_inputs(shapes, 1, 2, 4, 0.6, seed=7)
    want = np.asarray(jgather(jnp.asarray(value), shapes, jnp.asarray(loc),
                                      jnp.asarray(attn)))
    got = ms_deform_attn(tt(value), shapes, tt(loc), tt(attn))
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_TOL, rtol=0)


def test_ms_deform_attn_matches_pallas_interpret():
    """The TPU kernel K6 in interpret mode, at the tiny pixel decoder's head
    width (D = 4); offsets up to 0.5 of the map also drive its gather
    residual. One case: interpret mode costs ~15 s a shape on a CPU."""
    shapes = ((4, 5), (8, 10), (16, 20))
    value, loc, attn = _sampler_inputs(shapes, 1, 2, 4, 0.5, seed=3)
    want = np.asarray(ms_deform_attn_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn), interpret=True))
    got = ms_deform_attn(tt(value), shapes, tt(loc), tt(attn))
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_TOL, rtol=0)


# ------------------------------------------------ jax.image.resize twins
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_bilinear_antialiased_downsample_matches_jax(factor):
    """The mask-attention bias's resize: 1/4 scale down to 1/8, 1/16, 1/32."""
    x = np.random.default_rng(factor).standard_normal((2, 3, 40, 48)).astype(np.float32)
    size = (40 // factor, 48 // factor)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *size), "bilinear"))
    got = F.interpolate(tt(x), size=size, mode="bilinear", align_corners=False,
                        antialias=True)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((5, 7), (8, 12))])
def test_nearest_upsample_matches_jax(src, dst):
    """The FPN's upsample (by 2), and a non-integer factor."""
    x = np.random.default_rng(1).standard_normal((2, 3, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *dst), "nearest"))
    got = resize_nearest(tt(x), dst)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bilinear_upsample_matches_jax():
    """The CLI's upsample of the mask logits to the ground truth's size."""
    x = np.random.default_rng(2).standard_normal((4, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (4, 3, 64, 48), "bilinear"))
    got = F.interpolate(tt(x), size=(64, 48), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_TOL, rtol=0)


# ------------------------------------------------------------ the models
def _numpy_params(shapes, seed: int, std: float = 0.05):
    """Random numpy leaves for the flax tree: norm scales 1 + noise, the
    offset biases the reference's grid plus noise, everything else
    N(0, std)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        noise = (std * rng.standard_normal(s.shape)).astype(s.dtype)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        if keys[-2:] == ["sampling_offsets", "bias"]:
            grid = jlayers._offset_bias_init(8, 3, 4)(None, s.shape)
            return np.asarray(grid) + noise
        return noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def dvis():
    """(JAX cfg, JAX model, numpy params, port model with the same weights)."""
    cfg = JDVISConfig.tiny()
    jmodel = JDVISPlus(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((FRAMES, SIZE, SIZE, 3)), num_frames=FRAMES,
        with_refiner=False))
    params = _numpy_params(shapes, seed=0)
    tmodel = DVISPlus(DVISConfig.tiny()).eval()
    tmodel.load_state_dict(convert_dvis(params), strict=True)
    return cfg, jmodel, params, tmodel


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(4)
    return rng.integers(0, 256, (FRAMES, SIZE, SIZE, 3)).astype(np.float32)


def _segmenter_stages(mod, images):
    """Every stage of the JAX segmenter at once (one compile): backbone
    features, pixel decoder outputs, decoder outputs, and the decoder's
    prediction heads on its final queries at each level's shape."""
    seg = mod.segmenter
    feats = seg.backbone(images)
    mask_features, maps = seg.pixel_decoder(feats)
    bt, h4, w4, c = mask_features.shape
    mf = mask_features.reshape(bt, 1, h4, w4, c)
    out = seg.decoder(maps, mf, 1)
    heads = [seg.decoder._predict(out["queries"], mf, m.shape[1:3]) for m in maps]
    return feats, mask_features, maps, out, heads


@pytest.fixture(scope="module")
def jax_fns(dvis):
    """The JAX segmenter's stages and its tracker, each jitted once and
    shared by the tests below (every compile of the tiny model costs
    several seconds on a CPU)."""
    jmodel = dvis[1]
    stages = jax.jit(lambda p, x: jmodel.apply(p, jnormalize(x), method=_segmenter_stages))
    track = jax.jit(lambda p, e, n, mf, s: jmodel.apply(
        p, e, n, mf, state=s, method=JDVISPlus.track))
    return stages, track


@pytest.fixture(scope="module")
def jax_stages(dvis, frames, jax_fns):
    return jax.tree.map(np.asarray, jax_fns[0](dvis[2], jnp.asarray(frames)))


def test_resnet50_matches_jax(dvis, frames, jax_stages):
    tmodel = dvis[3]
    with torch.no_grad():
        feats = tmodel.segmenter.backbone(normalize_pixels(tt(frames)))
    for name, want in jax_stages[0].items():
        assert feats[name].shape == want.shape, name
        assert rel_l2(feats[name], want) <= F32_TOL, name


def test_pixel_decoder_matches_jax(dvis, jax_stages):
    tmodel = dvis[3]
    feats, mask_features, maps = jax_stages[0], jax_stages[1], jax_stages[2]
    with torch.no_grad():
        got_mf, got_maps = tmodel.segmenter.pixel_decoder(
            {k: tt(v) for k, v in feats.items()})
    assert rel_l2(got_mf, mask_features) <= F32_TOL
    assert len(got_maps) == 3
    for got, want in zip(got_maps, maps):
        assert got.shape == want.shape
        assert rel_l2(got, want) <= F32_TOL


def test_mask_decoder_matches_jax(dvis, jax_stages):
    tmodel = dvis[3]
    mask_features, maps, out, heads = jax_stages[1:]
    mf = tt(mask_features)[:, None]
    with torch.no_grad():
        got = tmodel.segmenter.decoder([tt(m) for m in maps], mf, 1)
        for key in ("pred_logits", "pred_masks", "pred_embds", "queries"):
            assert rel_l2(got[key], out[key]) <= F32_TOL, key
        for got_aux, want_aux in zip(got["aux_outputs"], out["aux_outputs"]):
            assert rel_l2(got_aux["pred_masks"], want_aux["pred_masks"]) <= F32_TOL
        # the attention-bias masks from the same queries, at every level's
        # shape: the thresholded antialiased resize flips no entry
        queries = tt(out["queries"])
        allowed = []
        for (_, want_masks, want_bias, _), m in zip(heads, maps):
            _, masks, bias, _ = tmodel.segmenter.decoder.predict(queries, mf, m.shape[1:3])
            assert rel_l2(masks, want_masks) <= F32_TOL
            np.testing.assert_array_equal((bias == 0).numpy(), want_bias == 0)
            allowed.append((want_bias == 0).ravel())
        allowed = np.concatenate(allowed)
        assert 0 < allowed.sum() < allowed.size  # both kinds of entry occur


def test_tracker_two_windows_match_jax(dvis, jax_fns):
    """Two 3-frame windows, the second resuming the first's state."""
    cfg, _, params, tmodel = dvis
    track = jax_fns[1]
    rng = np.random.default_rng(5)
    q, c, hw = cfg.segmenter.decoder.num_queries, cfg.tracker.hidden_dim, SIZE // 4
    jstate, tstate = None, None
    for _ in range(2):
        embds = rng.standard_normal((1, FRAMES, q, c)).astype(np.float32)
        norm = embds / (np.linalg.norm(embds, axis=-1, keepdims=True) + 1e-6)
        mf = rng.standard_normal((1, FRAMES, hw, hw, c)).astype(np.float32)
        want, jstate = track(params, norm, embds, mf, jstate)
        with torch.no_grad():
            got, tstate = tmodel.track(tt(norm), tt(embds), tt(mf), state=tstate)
        for key in ("pred_logits", "pred_masks", "pred_embds", "pred_references"):
            assert rel_l2(got[key], want[key]) <= F32_TOL, key
        for got_i, want_i in zip(got["ret_indices"], want["ret_indices"]):
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        for key in ("last_output", "last_frame_embeds"):
            assert rel_l2(tstate[key], jstate[key]) <= F32_TOL, key


def _jax_window_step(jax_fns, params, window: int, arch: str):
    """The JAX CLI's ``make_window_step`` (``mmor_tpu/cli/eval_panoptic.py``,
    its lines 39-61: normalize, ``segment_frames``, regroup, ``track``) over
    the stages and tracker compiled once here, rather than three more
    compiles of the whole model (~11 s each on a CPU)."""
    stages, track = jax_fns

    def step(frames, state):
        _, mask_features, _, seg, _ = stages(params, jnp.asarray(frames))
        if arch == "minvis":
            return {"pred_logits": np.asarray(seg["pred_logits"]),
                    "pred_masks": np.asarray(seg["pred_masks"][:, :, 0]),
                    "pred_embds": np.asarray(seg["pred_embds"])}, state
        q, c = seg["pred_embds"].shape[1:]
        embds = seg["pred_embds"].reshape(1, window, q, c)
        norm = embds / (jnp.linalg.norm(embds, axis=-1, keepdims=True) + 1e-6)
        mf = mask_features.reshape(1, window, *mask_features.shape[1:])
        out, new_state = track(params, norm, embds, mf, state)
        return {"pred_logits": np.asarray(out["pred_logits"][0]),
                "pred_masks": np.asarray(out["pred_masks"][0].transpose(1, 0, 2, 3))}, new_state

    return step


def test_dvis_window_step_matches_jax(dvis, frames, jax_fns):
    """The port's CLI window step against the JAX one (below), one window."""
    cfg, _, params, tmodel = dvis
    want, _ = _jax_window_step(jax_fns, params, cfg.window_size, "dvis")(frames, None)
    got, state = tcli.make_window_step(tmodel, cfg.window_size)(frames, None)
    assert got["pred_logits"].shape == (FRAMES, 8, 11)
    assert got["pred_masks"].shape == (FRAMES, 8, SIZE // 4, SIZE // 4)
    for key in ("pred_logits", "pred_masks"):
        assert rel_l2(got[key], want[key]) <= STEP_TOL, key
    assert set(state) == {"last_output", "last_frame_embeds"}


@pytest.mark.parametrize("arch", ["dvis", "minvis"])
def test_evaluate_videos_matches_jax_cli(dvis, jax_fns, monkeypatch, tmp_path, arch):
    """Both CLIs' ``evaluate_videos`` on their synthetic videos (the same
    frames) with the same weights: 4 frames, so the second window resumes
    the tracker's state on a padded window. The object threshold is lowered
    so that random weights keep queries and the panoptic maps are not
    empty."""
    cfg, jmodel, params, tmodel = dvis
    monkeypatch.setattr(jcli, "make_window_step", lambda model, p, window, arch="dvis":
                        _jax_window_step(jax_fns, p, window, arch))
    jvideo = list(jcli._synthetic_videos(SIZE, SIZE, cfg))
    tvideo = list(tcli._synthetic_videos(SIZE, SIZE))
    for a, b in zip(jvideo[0]["file_names"], tvideo[0]["file_names"]):
        np.testing.assert_array_equal(read_png(a), read_png(b))
    want = jcli.evaluate_videos(jmodel, params, iter(jvideo),
                                JDVISConfig.tiny(object_mask_threshold=0.0),
                                output_dir=tmp_path / "jax", arch=arch)
    got = tcli.evaluate_videos(tmodel, iter(tvideo), DVISConfig.tiny(object_mask_threshold=0.0),
                               output_dir=tmp_path / "torch", arch=arch)
    assert got["vpq"] == want["vpq"] and got["stq"] == want["stq"]
    pngs = sorted((tmp_path / "jax").rglob("*.png"))
    assert len(pngs) == 4
    maps = [read_png(p) for p in pngs]
    assert any(m.any() for m in maps)  # some segment was predicted
    for p, m in zip(pngs, maps):
        np.testing.assert_array_equal(
            read_png(tmp_path / "torch" / p.relative_to(tmp_path / "jax")), m)


def read_png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def test_panoptic_cli_defaults_to_the_card(monkeypatch):
    """Without a card the CLI raises at entry instead of running on the CPU
    (``--device cpu`` must be asked for), and ``--checkpoint`` raises until
    a DVIS++ checkpoint converter exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--synthetic", "--tiny"])
    with pytest.raises(NotImplementedError, match="checkpoint"):
        tcli.main(["--synthetic", "--tiny", "--device", "cpu", "--checkpoint", "ckpt"])


def test_panoptic_cli_needs_a_data_root_without_synthetic(capsys):
    """Without --synthetic the CLI reads no default tree around the checkout:
    it refuses to start until --data_root names one."""
    with pytest.raises(SystemExit):
        tcli.main(["--device", "cpu", "--tiny"])
    assert "--data_root is required" in capsys.readouterr().err
