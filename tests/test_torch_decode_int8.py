"""The int8-cache decode kernel's CPU side: the append's plain path, the
quantizer it carries, the widening it does, and its planner against its
CUDA source (`src/repro_torch/csrc/decode_attention_int8.cu`).

`decode_attention_int8_append` quantizes the new token's k and v, writes
them at `slot` and attends, in one launch on the card; on the CPU it is
the model's former sequence (`ref.quantize_kv`, four writes,
`ref.decode_attention_ref`), which these tests hold bit for bit, with the
quantizer held to the reference's (`repro/models/attention.py:123-130`).
The kernel itself is held against this plain path on the card in
`tests/test_torch_gpu.py`.  Inputs come from numpy seeds."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.models import attention
from test_torch_window_int8 import quantizer_inputs, reference_quantize

SRC = (_build.CSRC / "decode_attention_int8.cu").read_text()
# (G, D) of tests/test_torch_gpu.py::test_decode_int8_kernel_matches_plain,
# and the widest: qwen3's G 16 at D 128 and 256
KERNEL_SHAPES = [(1, 64), (2, 256), (4, 128), (6, 128), (16, 128), (8, 128),
                 (1, 80), (1, 20), (4, 16), (16, 256)]


def const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def int8_cache(rng, B, KVH, S, D, dtype):
    """Head-major int8 caches and scales quantized from random rows."""
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((B, KVH, S, D), np.float32)
                             * rng.uniform(0.1, 3.0, (B, KVH, S, 1)).astype(
                                 np.float32)).to(dtype)
        out += list(ref.quantize_kv(x))
    return out


# ----------------------------------------------------------------------
# the append's plain path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,valid,slot", [
    (16, 16, 37 % 16),        # a full ring past its wrap: slot pos % W
    (16, 16, 15),             # the ring's last slot
    (40, 1, 0),               # the first token
    (40, 29, 28)])            # a linear cache: slot pos, valid pos + 1
def test_append_is_quantize_write_attend(dtype, S, valid, slot):
    """The CPU path writes the payload and scales of `quantize_kv` at
    `slot`, bit for bit, touches no other row, and attends as
    `decode_attention_ref` over the written cache."""
    rng = np.random.default_rng(S + slot)
    B, KVH, G, D = 3, 2, 4, 32
    k, ks, v, vs = int8_cache(rng, B, KVH, S, D, dtype)
    q, k_new, v_new = (torch.from_numpy(rng.standard_normal(
        shape, np.float32)).to(dtype) for shape in (
            (B, KVH * G, D), (B, KVH, D), (B, KVH, D)))
    got = [t.clone() for t in (k, v, ks, vs)]
    out = ops.decode_attention_int8_append(q, k_new, v_new, *got, slot,
                                           valid)
    want = [t.clone() for t in (k, v, ks, vs)]
    (k8, s8), (v8, sv) = ref.quantize_kv(k_new), ref.quantize_kv(v_new)
    for t, row in zip(want, (k8, v8, s8, sv)):
        t[:, :, slot] = row
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.uint8) if g.dtype == torch.int8
                           else g.view(torch.int32),
                           w.view(torch.uint8) if w.dtype == torch.int8
                           else w.view(torch.int32))
    assert torch.equal(out, ref.decode_attention_ref(
        q, want[0].transpose(1, 2), want[1].transpose(1, 2), valid,
        want[2], want[3]))
    assert out.dtype == dtype and out.shape == q.shape


def test_append_rejects_what_it_does_not_take():
    rng = np.random.default_rng(0)
    k, ks, v, vs = int8_cache(rng, 1, 2, 8, 16, torch.float32)
    q = torch.zeros(1, 4, 16)
    new = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match=r"slot 5 not in \[0, 5\)"):
        ops.decode_attention_int8_append(q, new, new, k, v, ks, vs, 5, 5)
    with pytest.raises(ValueError, match="k_new must be"):
        ops.decode_attention_int8_append(q, new[:, :1], new, k, v, ks, vs,
                                         0, 5)
    with pytest.raises(ValueError, match="v_new must be"):
        ops.decode_attention_int8_append(q, new, new.bfloat16(), k, v, ks,
                                         vs, 0, 5)
    with pytest.raises(ValueError, match="takes an int8 cache"):
        ops.decode_attention_int8_append(q, new, new, k.float(), v.float(),
                                         ks, vs, 0, 5)


# ----------------------------------------------------------------------
# the quantizer the append carries
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moved_quantizer_is_the_references_bit_for_bit(dtype):
    """`kernels.ref.quantize_kv` (re-exported as the model's) against the
    reference's inline quantizer, half-step ties included; the floor the
    card's kernel takes is the reference's 1e-8 in bf16."""
    assert attention.quantize_kv is ref.quantize_kv
    x = quantizer_inputs(np.random.default_rng(1))
    want_q, want_s = reference_quantize(jnp.asarray(x).astype(dtype))
    got_q, got_s = ref.quantize_kv(torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    tie = (np.abs(x[1]) * 32) % 2 == 1
    assert tie.sum() > 40
    assert (got_q[1].numpy()[tie].astype(np.int64) % 2 == 0).all()
    floor = np.asarray(jnp.asarray(1e-8, jnp.bfloat16).astype(jnp.float32))
    assert tdecode._BF16_FLOOR == float(floor)


def test_widening_is_exact_for_every_int8():
    """The kernel's widening, byte for byte: x ^ 0x80 into the low byte of
    the float 0x4B000000 (2**23 + x + 128), minus 2**23 + 128, then the
    upper 16 bits as bf16, gives every int8 exactly."""
    magic = int(re.search(r"__byte_perm\(w, (0x[0-9A-F]+)u, 0x7440\)",
                          SRC).group(1), 16)
    sub = float(re.search(r"const float magic = ([\d.]+)f;", SRC).group(1))
    assert re.search(r"w \^= 0x80808080u;", SRC)
    assert re.search(r"__byte_perm\(f0, f1, 0x7632\)", SRC)
    x = np.arange(-128, 128, dtype=np.int64)
    bits = (magic & 0xFFFFFF00) | ((x & 0xFF) ^ 0x80)
    f = bits.astype(np.uint32).view(np.float32) - np.float32(sub)
    upper = (f.view(np.uint32) >> 16).astype(np.uint16)
    widened = torch.from_numpy(upper.view(np.int16)).view(torch.bfloat16)
    assert torch.equal(widened.float(), torch.from_numpy(x).float())
    assert (f.view(np.uint32) & 0xFFFF == 0).all()   # nothing left below


# ----------------------------------------------------------------------
# the planner against the source
# ----------------------------------------------------------------------
def test_int8_constants_agree_with_the_source():
    assert const("NCW") == tdecode._INT8_NCW
    assert const("WT") == tdecode._INT8_WT
    assert re.search(r"constexpr int TILE = NCW \* WT;", SRC)
    assert tdecode.INT8_TILE == tdecode._INT8_NCW * tdecode._INT8_WT
    assert (const("MIN_STAGES"), const("MAX_STAGES")) == tdecode._INT8_STAGES
    assert const("SMEM_LIMIT") == tdecode._INT8_SMEM_LIMIT
    assert const("MAX_SPLITS") == tdecode._MAX_SPLITS
    assert const("MAXG") == tdecode._MAX_G and const("MAXD") == tdecode._MAX_D
    # the shared-memory layout that int8_smem_bytes mirrors
    for line in (r"L.pd = \(D \+ 15\) / 16 \* 16;",
                 r"L.stage = 2 \* TILE \* L.pd \+ 2 \* TILE \* 4;",
                 r"const int merge = NCW \* G \* L.pd \* 4 \+ 2 \* NCW \* G "
                 r"\* 4;",
                 r"const int weights = MAX_SPLITS \* G \* 4;",
                 r"L.vpitch = 2 \* L.pd \+ 16;",
                 r"L.newrow = L.qfrag \+ groups\(D\) \* 4 \* 32 \* 16;",
                 r"L.bars = L.newrow \+ 2 \* L.pd \+ 16;",
                 r"L.flag = L.bars \+ 2 \* stages \* 8;",
                 r"L.total = L.flag \+ 16;"):
        assert re.search(line, SRC), line


@pytest.mark.parametrize("G,D", KERNEL_SHAPES)
def test_int8_ring_fits_shared_memory(G, D):
    """Every (G, D) the kernel is tested at fits 227 KB a block with the
    blocks an SM its registers are bounded for (228 KB, 1 KB reserved a
    block); the ring keeps at least 32 KB of K/V loads in flight an SM at
    D >= 64."""
    assert re.search(r"return DC > 128 \? 1 : exact \? 3 : 2;", SRC)
    assert re.search(r"__launch_bounds__\(NT, min_blocks\(DC, EXACT\)\)",
                     SRC)
    assert re.search(r"if \(D == 64\) return f\(decode_int8_kernel<64, "
                     r"true>\);", SRC)
    assert re.search(r"if \(D == 128\) return f\(decode_int8_kernel<128, "
                     r"true>\);", SRC)
    blocks = tdecode.int8_blocks(D)
    assert blocks == (1 if D > 128 else 3 if D in (64, 128) else 2)
    stages = tdecode.int8_stages(D, G)
    lo, hi = tdecode._INT8_STAGES
    assert lo <= stages <= hi
    smem = tdecode.int8_smem_bytes(D, G, stages)
    assert smem <= tdecode._INT8_SMEM_LIMIT
    assert blocks * (smem + tdecode._SMEM_RESERVED) <= tdecode._SM_SMEM
    if stages < hi:
        assert blocks * (tdecode.int8_smem_bytes(D, G, stages + 1)
                         + tdecode._SMEM_RESERVED) > tdecode._SM_SMEM
    pd = -(-D // 16) * 16
    if D >= 64:
        assert blocks * stages * 2 * tdecode.INT8_TILE * pd >= 32 * 1024
    # the merges' scratch (the warps' states, the splits' weights) fits
    # in the ring it reuses
    ring = smem - (tdecode._INT8_NCW * tdecode._INT8_WT * (2 * pd + 16)
                   + -(-D // 64) * 2048 + 2 * pd + 32 + 16 * stages)
    assert ring >= tdecode._INT8_NCW * G * pd * 4 + 2 * tdecode._INT8_NCW * G * 4
    assert ring >= tdecode._MAX_SPLITS * G * 4


@pytest.mark.parametrize("B,KVH,valid", [(4, 8, 129), (8, 8, 30_001),
                                         (4, 4, 1024), (1, 1, 8000),
                                         (3, 2, 1), (2, 8, 613)])
def test_int8_splits_cover_valid_len_and_hold_the_slot(B, KVH, valid):
    """Splits are whole stages and cover [0, valid_len) exactly (the
    kernel's s_begin / s_end), none empty; every slot in [0, valid_len)
    lies in exactly one split, whose block appends it."""
    assert re.search(r"const int s_begin = split \* a.split_len;", SRC)
    assert re.search(r"const int s_end = min\(s_begin \+ a.split_len, "
                     r"a.valid_len\);", SRC)
    assert re.search(r"const bool has_slot = a.slot >= s_begin && a.slot < "
                     r"s_end;", SRC)
    tile = tdecode.INT8_TILE
    for slots in (1, 132, 2 * 132, 4 * 132):
        split_len, n = tdecode.plan_splits(B, KVH, valid, tile, slots)
        assert split_len % tile == 0 and 1 <= n <= tdecode._MAX_SPLITS
        assert B * KVH * n <= max(slots, B * KVH)
        spans = [(s * split_len, min(s * split_len + split_len, valid))
                 for s in range(n)]
        assert all(lo < hi for lo, hi in spans)
        assert spans[0][0] == 0 and spans[-1][1] == valid
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        for slot in {0, valid - 1, valid // 2, min(split_len, valid - 1),
                     min(split_len - 1, valid - 1)}:
            assert sum(lo <= slot < hi for lo, hi in spans) == 1
