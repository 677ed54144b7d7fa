"""K1's skip rule (``mmor_tpu_torch.ops.attention.flash_tiles``) against the
JAX package's own mask.

The CUDA kernel visits only the key tiles the rule keeps, so the rule must
keep every tile that holds a visible (query, key) pair. The visible set comes
from ``mmor_tpu.ops.attention.mha_reference``: with every query a ones
vector, key j's logit 0.01 j / sqrt(D) and V the identity (D = Sk), each
output row is the row's softmax weights, positive exactly on its visible
keys. A row with no visible key comes out uniform over all keys (the
reference then averages V); those rows need no tile and are left out. For
sorted patches, with or without the -1 tail, the rule must also visit no
tile without a visible pair.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu.ops import attention as jattn
from mmor_tpu_torch.ops import attention as tattn
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores


def jax_visible(sq, sk, causal, seg, kv_seg):
    """(B, Sq, Sk) visible pairs and (B, Sq) rows with no visible key, as
    the JAX reference masks them."""
    b = 1 if seg is None else seg.shape[0]
    q = np.ones((b, 1, sq, sk), np.float32)
    k = np.zeros((b, 1, sk, sk), np.float32)
    k[:, 0, np.arange(sk), 0] = 0.01 * np.arange(sk)
    v = np.broadcast_to(np.eye(sk, dtype=np.float32), (b, 1, sk, sk))
    kw = {}
    if seg is not None:
        kw = dict(segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(kv_seg))
    w = np.asarray(jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, **kw))[:, 0]
    no_key = np.ptp(w, axis=-1) == 0  # uniform over all keys: nothing visible
    return w > 0, no_key


def port_tiles(sq, sk, causal, seg, kv_seg, block_q, block_k):
    b = 1 if seg is None else seg.shape[0]
    q_seg, kv_seg = tattn.flash_segments(
        b, sq, sk, None if seg is None else torch.from_numpy(seg),
        None if kv_seg is None else torch.from_numpy(kv_seg), torch.device("cpu"))
    return tattn.flash_tiles(tattn.segment_tiles(q_seg, block_q),
                             tattn.segment_tiles(kv_seg, block_k),
                             sq, sk, causal, block_q, block_k).numpy()


def tiles_with_visible_pairs(visible, no_key, block_q, block_k):
    b, sq, sk = visible.shape
    need = np.zeros((b, -(-sq // block_q), -(-sk // block_k)), bool)
    bi, qi, ki = np.nonzero(visible & ~no_key[:, :, None])
    need[bi, qi // block_q, ki // block_k] = True
    return need


@functools.cache
def case(kind):
    """The inputs of ``kind`` and their visible pairs, computed once for both
    tile sizes."""
    sq, sk, causal, seg, kv_seg = inputs(kind, np.random.default_rng(0))
    return (sq, sk, causal, seg, kv_seg, *jax_visible(sq, sk, causal, seg, kv_seg))


def inputs(kind, rng):
    """(Sq, Sk, causal, query segment ids, key segment ids)."""
    if kind == "patches_tail":  # sorted patches, the invalid tail -1 (PTv3)
        seg = np.repeat((np.arange(700) // 100)[None], 2, 0).astype(np.int32)
        seg[:, 610:] = -1
        return 700, 700, False, seg, seg
    if kind == "patches":  # sorted patches, no tail
        seg = np.repeat((np.arange(700) // 100)[None], 2, 0).astype(np.int32)
        return 700, 700, False, seg, seg
    if kind == "absent_views":  # the pooler's absent views as segment 0
        seg = np.ones((2, 450), np.int32)
        seg[0, 300:] = 0
        seg[1, 150:] = 0
        return 450, 450, False, seg, seg
    if kind == "unsorted":  # random ids, separate key ids, Sq != Sk
        return (270, 390, False, rng.integers(0, 4, (2, 270)).astype(np.int32),
                rng.integers(0, 4, (2, 390)).astype(np.int32))
    if kind == "causal_short_q":  # causal with Sq < Sk, left-padded keys
        kv = np.ones((2, 450), np.int32)
        kv[1, :40] = 0
        seg = kv[:, -200:].copy()
        return 200, 450, True, seg, kv
    if kind == "causal_leftpad":  # the LLaMA prefill's mask, at Sq = Sk
        seg = np.ones((3, 330), np.int32)
        for r in range(3):
            seg[r, : 60 * r] = 0
        return 330, 330, True, seg, seg
    if kind == "unmasked":
        return 300, 260, False, None, None
    raise ValueError(kind)


KINDS = ["patches_tail", "patches", "absent_views", "unsorted", "causal_short_q",
         "causal_leftpad", "unmasked"]


@pytest.mark.parametrize("blocks", [(tattn.FLASH_BLOCK_Q, tattn.FLASH_BLOCK_K), (32, 48)],
                         ids=["kernel_tiles", "small_tiles"])
@pytest.mark.parametrize("kind", KINDS)
def test_flash_tiles_keep_every_visible_pair(kind, blocks):
    block_q, block_k = blocks
    sq, sk, causal, seg, kv_seg, visible, no_key = case(kind)
    tiles = port_tiles(sq, sk, causal, seg, kv_seg, block_q, block_k)
    need = tiles_with_visible_pairs(visible, no_key, block_q, block_k)
    assert tiles.shape == need.shape
    missed = need & ~tiles
    assert not missed.any(), f"tiles with visible pairs skipped: {np.argwhere(missed)[:5]}"
    if kind in ("patches", "patches_tail"):  # no more than the patches' own tiles
        np.testing.assert_array_equal(tiles, need)
    if kind in ("patches_tail", "absent_views", "causal_short_q"):
        assert tiles.sum() < tiles.size  # the rule skips something here


def test_flash_tiles_skip_rows_without_keys():
    """A query tile whose segment no key carries visits nothing."""
    seg = np.zeros((1, 256), np.int32)
    seg[0, 128:] = 5
    kv = np.zeros((1, 256), np.int32)
    visible, no_key = jax_visible(256, 256, False, seg, kv)
    assert no_key[0, 128:].all() and not no_key[0, :128].any()
    tiles = port_tiles(256, 256, False, seg, kv, 128, 128)
    np.testing.assert_array_equal(tiles[0], [[True, True], [False, False]])
