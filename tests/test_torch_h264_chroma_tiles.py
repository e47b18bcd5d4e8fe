"""B6 chroma's chunk kernel, modelled in numpy int32, ≡ the plain chains.

``ed_h264_requant_chroma`` (``csrc/h264_kernels.cu``) cannot run on the
CPU, so its arithmetic is written out here as the kernel does it and held
bit for bit against the port's plain ``ops.transform.h264_requant_chroma``
and JAX ``h264_requant_chroma`` (the reference, on the CPU), with inputs
made from a seed:

* the per-row half (``row_arm``): the arm, and each right shift of a
  level by a clamped amount in 0..31 in place of torch's guarded shift
  (the sign fill for an amount < 0 or >= 32 is ``x >> 31``), the
  dequant's left shift folded into the V multipliers, V and MF selected by
  ``qp % 6``;
* the four-lane split, one lane a 4×4 block, with the chroma DC's 2×2
  Hadamard as two butterflies exchanged between a row's lanes
  (``__shfl_xor_sync`` by 1, then by 2);
* a warp (one chunk of eight rows) runs the general arm's transform only
  when one of its rows takes that arm, and then one last step serves
  every row: a general row's forward coefficient times MF shifted by
  qbits, or a shift or identity row's clipped level times 1 shifted by k;
  a warp without a general row shifts or clips;
* the chunk loop: 8-row chunks, a ragged last one whose dead rows hold
  stale words and take the identity.

Every ``(qpc_in, qpc_out)`` in −12…63 squared, every arm, levels at and
beyond ±``LEVEL_CLIP`` and the int32 extremes, as levels and as QPs.  The
chroma leg's card buffer puts every segment on a 16-byte boundary.
"""

import numpy as np
import pytest
import torch

from easydarwin_tpu.ops import transform as jax_tf
from easydarwin_tpu_torch.codecs.h264_transform import (LEVEL_CLIP, MF,
                                                        RES_CLIP, V, W_CLIP,
                                                        ZIGZAG4, _CLS)
from easydarwin_tpu_torch.ops import h264_kernel as hk
from easydarwin_tpu_torch.ops import transform as tf
from chip_smoke import chroma_arm_qps

#: csrc/h264_kernels.cu kChromaChunkRows: rows a warp's chunk (four lanes
#: a row)
CHUNK_ROWS = 8
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
QP_RANGE = range(-12, 64)


# ------------------------------------------------------ int32 as the card
def wrap(a):
    """Modulo 2^32 into int32's range (the kernel's unsigned add, sub and
    mul), kept in int64 arrays."""
    a = np.asarray(a, np.int64)
    return ((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def shl(a, s):
    """The kernel's guarded ``shl``: 0 for s < 0 or s >= 32."""
    a, s = np.broadcast_arrays(np.asarray(a, np.int64),
                               np.asarray(s, np.int64))
    ok = (s >= 0) & (s < 32)
    return np.where(ok, wrap(a << np.where(ok, s, 0)), 0)


def rshift_amount(s):
    """``rshift_amount``: torch's x >> s for s outside 0..31 is x >> 31."""
    s = np.asarray(s, np.int64)
    return np.where((s < 0) | (s > 31), 31, s)


def clip(a, lim):
    return np.clip(a, -lim, lim)


def iabs(a):
    return wrap(np.abs(a))          # |INT_MIN| stays INT_MIN


def round_shift(x, s, f):
    """sign(x) * ((|x| + f) >> s), s in 0..31."""
    z = wrap(iabs(x) + f) >> s
    return np.where(x > 0, z, np.where(x < 0, wrap(-z), 0))


# ------------------------------------------------------------ the kernel
def row_arm(qi, qo, live):
    """The per-row half, one entry a row (``RowArm``)."""
    qi, qo = np.asarray(qi, np.int64), np.asarray(qo, np.int64)
    delta = wrap(qo - qi)
    arm = np.where(~live | (delta == 0), 0, np.where(delta % 6 == 0, 1, 2))
    k = np.maximum(delta // 6, 0)
    qbits = 15 + qo // 6
    off = shl(1, qbits) // 3
    return {"arm": arm, "kc": np.minimum(k, 31), "f6": shl(1, k) // 3,
            "vs": shl(V[qi % 6], (qi // 6)[:, None]),     # [R, 3]
            "mf": MF[qo % 6].astype(np.int64),             # [R, 3]
            "qb": rshift_amount(qbits), "off": off,
            "qb1": rshift_amount(qbits + 1), "off2": wrap(2 * off)}


def hadamard4(x):
    """[R, 4] one value a lane: the two xor butterflies of ``hadamard4``."""
    b = np.arange(4)
    for m in (1, 2):
        y = x[:, b ^ m]
        x = np.where(b & m, wrap(y - x), wrap(x + y))
    return x


def _inv_core(a, b, c, d):
    e0, e1 = wrap(a + c), wrap(a - c)
    e2, e3 = wrap((b >> 1) - d), wrap(b + (d >> 1))
    return wrap(e0 + e3), wrap(e1 + e2), wrap(e1 - e2), wrap(e0 - e3)


def _fwd_core(x0, x1, x2, x3):
    t0, t1, t2, t3 = wrap(x0 + x3), wrap(x1 + x2), wrap(x1 - x2), \
        wrap(x0 - x3)
    return (wrap(t0 + t1), wrap(wrap(2 * t3) + t2), wrap(t0 - t1),
            wrap(t3 - wrap(2 * t2)))


def _butterflies(w, fn):
    """``fn`` over the rows, then the columns, of [R, 4, 16] blocks."""
    w = w.copy()
    for i in range(4):
        idx = [4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3]
        w[..., idx] = np.stack(fn(*(w[..., j] for j in idx)), -1)
    for c in range(4):
        idx = [c, 4 + c, 8 + c, 12 + c]
        w[..., idx] = np.stack(fn(*(w[..., j] for j in idx)), -1)
    return w


def general_transform(r, dc, ac):
    """The general arm's transform for every lane of the rows: (w [R, 4,
    16] the clipped forward coefficients in raster order, g [R, 4] the DC
    requant's input)."""
    vs = r["vs"][:, None, :]
    w = np.zeros(ac.shape[:2] + (16,), np.int64)
    w[..., 0] = wrap(hadamard4(clip(dc, LEVEL_CLIP)) * vs[..., 0]) >> 1
    for j in range(1, 16):
        p = ZIGZAG4[j]
        w[..., p] = wrap(clip(ac[..., j - 1], LEVEL_CLIP) * vs[..., _CLS[p]])
    w = _butterflies(w, _inv_core)
    w = clip(wrap(w + 32) >> 6, RES_CLIP)
    w = clip(_butterflies(w, _fwd_core), W_CLIP)
    return w, clip(hadamard4(w[..., 0]), W_CLIP)


def last_step(r, dc, ac, w, g):
    """The requant at qpc_out that a warp with a general row runs for all
    its rows: general rows from (w, g) times MF by qbits, the others from
    their clipped levels times 1 by k."""
    gen = (r["arm"] == 2)[:, None]
    col = {k: r[k][:, None] for k in ("qb", "off", "qb1", "off2", "kc",
                                      "f6")}
    mf = r["mf"][:, None, :]
    v_dc = np.where(gen, wrap(g * mf[..., 0]), clip(dc, LEVEL_CLIP))
    dc_o = clip(round_shift(v_dc, np.where(gen, col["qb1"], col["kc"]),
                            np.where(gen, col["off2"], col["f6"])),
                LEVEL_CLIP)
    s = np.where(gen, col["qb"], col["kc"])[..., None]
    o = np.where(gen, col["off"], col["f6"])[..., None]
    v_ac = np.stack([np.where(gen, wrap(w[..., ZIGZAG4[j]]
                                        * mf[..., _CLS[ZIGZAG4[j]]]),
                              clip(ac[..., j - 1], LEVEL_CLIP))
                     for j in range(1, 16)], -1)
    return dc_o, clip(round_shift(v_ac, s, o), LEVEL_CLIP)


def shift_or_clip(r, dc, ac):
    """A warp without a general row: the exact shift for arm 1, the clip
    otherwise."""
    k, f = r["kc"][:, None], r["f6"][:, None]
    sh = r["arm"][:, None] == 1
    dc_s = np.where(sh, round_shift(clip(dc, LEVEL_CLIP), k, f),
                    clip(dc, LEVEL_CLIP))
    ac_s = np.where(sh[..., None], round_shift(clip(ac, LEVEL_CLIP),
                                               k[..., None], f[..., None]),
                    clip(ac, LEVEL_CLIP))
    return dc_s, ac_s


def requant_chunk(dc, ac, qi, qo, rows):
    """One warp's chunk in place (``requant_block`` on its 32 lanes):
    [CHUNK_ROWS] rows of which ``rows`` are live; returns (dc', ac',
    whether the warp ran the general transform)."""
    r = row_arm(qi, qo, np.arange(len(qi)) < rows)
    if (r["arm"] == 2).any():
        return (*last_step(r, dc, ac, *general_transform(r, dc, ac)), True)
    return (*shift_or_clip(r, dc, ac), False)


def kernel_model(dc, ac, qi, qo, rng):
    """``chroma_ring`` over all rows: 8-row chunks whose rows past a
    ragged last chunk hold stale words (from ``rng``); the outputs of the
    live rows."""
    n = dc.shape[0]
    out_dc = np.empty((n, 4), np.int64)
    out_ac = np.empty((n, 4, 15), np.int64)
    for row0 in range(0, n, CHUNK_ROWS):
        rows = min(CHUNK_ROWS, n - row0)

        def stage(a):
            s = rng.integers(INT_MIN, INT_MAX, (CHUNK_ROWS,) + a.shape[1:],
                             dtype=np.int64, endpoint=True)
            s[:rows] = a[row0:row0 + rows]
            return s
        d, a, _ = requant_chunk(stage(dc), stage(ac), stage(qi), stage(qo),
                                rows)
        out_dc[row0:row0 + rows] = d[:rows]
        out_ac[row0:row0 + rows] = a[:rows]
    return out_dc.astype(np.int32), out_ac.astype(np.int32)


# ---------------------------------------------------------------- inputs
def _levels(rng, n):
    """DC [n, 4] and AC [n, 4, 15] int32: mostly small, some at and
    beyond ±LEVEL_CLIP, a few int32 extremes."""
    dc = rng.integers(-700, 701, (n, 4))
    ac = rng.integers(-120, 121, (n, 4, 15)) * (rng.random((n, 4, 15)) < 0.4)
    for a in (dc, ac):
        flat = a.reshape(-1)
        pick = rng.random(flat.size)
        flat[pick < 0.03] = rng.choice(
            [LEVEL_CLIP, -LEVEL_CLIP, LEVEL_CLIP + 1, -LEVEL_CLIP - 1,
             5 * LEVEL_CLIP, -9 * LEVEL_CLIP], int((pick < 0.03).sum()))
        flat[pick > 0.995] = rng.choice([INT_MIN, INT_MAX, INT_MIN + 1],
                                        int((pick > 0.995).sum()))
    return dc.astype(np.int32), ac.astype(np.int32)


def _plain(dc, ac, qi, qo):
    d, a = tf.h264_requant_chroma(*(torch.from_numpy(x)
                                    for x in (dc, ac, qi, qo)))
    return d.numpy(), a.numpy()


def _jax(dc, ac, qi, qo):
    d, a = jax_tf.h264_requant_chroma(dc, ac, qi, qo)
    return np.asarray(d), np.asarray(a)


def _all_equal(dc, ac, qi, qo, seed):
    want = _plain(dc, ac, qi, qo)
    got = kernel_model(dc, ac, qi, qo, np.random.default_rng(seed))
    ref = _jax(dc, ac, qi, qo)
    for g, w, j in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)
    return want


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("qpc_in", QP_RANGE)
def test_every_qp_pair_equals_the_plain_chain_and_jax(qpc_in):
    """qpc_in fixed, qpc_out over −12…63, three rows a pair: 228 rows, so
    the ragged last chunk has 4 live rows."""
    rng = np.random.default_rng(1000 + qpc_in)
    qo = np.repeat(np.arange(-12, 64), 3).astype(np.int32)
    qi = np.full_like(qo, qpc_in)
    dc, ac = _levels(rng, qo.size)
    _all_equal(dc, ac, qi, qo, 100 + qpc_in)


QP_EXTREMES = [(INT_MIN, INT_MAX), (INT_MAX, INT_MIN), (0, INT_MAX),
               (INT_MAX, 0), (INT_MIN, 0), (0, INT_MIN), (INT_MIN, INT_MIN),
               (INT_MAX, INT_MAX), (-7, 2 ** 31 - 6), (51, 51 + 6 * 5),
               (96, 99), (90, 186), (-200, 10), (INT_MIN + 5, INT_MAX - 4)]


@pytest.mark.parametrize("qpc_in,qpc_out", QP_EXTREMES)
def test_int32_extreme_qps_equal_the_plain_chain_and_jax(qpc_in, qpc_out):
    rng = np.random.default_rng(abs(qpc_in) % 997 + abs(qpc_out) % 991)
    n = 72
    dc, ac = _levels(rng, n)
    qi = np.full(n, qpc_in, np.int32)
    qo = np.full(n, qpc_out, np.int32)
    _all_equal(dc, ac, qi, qo, 7)


@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 11, 63, 65, 130, 257])
def test_mixed_arms_and_ragged_chunks(n):
    """Rows drawn as chip_smoke phase 5c draws them (Table 8-15 QPc of a
    luma QP and a step of 0, 6, 12 or 18: all three arms, random a row),
    over chunks whose last one is ragged."""
    from easydarwin_tpu_torch.codecs.h264_transform import CHROMA_QP
    rng = np.random.default_rng(n)
    qpy = rng.integers(0, 52, n)
    step = rng.choice([0, 6, 12, 18], n)
    qi = CHROMA_QP[qpy].astype(np.int32)
    qo = CHROMA_QP[np.minimum(qpy + step, 51)].astype(np.int32)
    dc, ac = _levels(rng, n)
    _all_equal(dc, ac, qi, qo, n)


@pytest.mark.parametrize("arm", ["identity", "shift", "general", "chunks"])
def test_uniform_arms(arm):
    """Every row one arm, and arms uniform within each chunk (chip_smoke's
    ``chroma_arm_qps``: chunk i's delta the i-th of 0, 6, 3, 12, 5, 18,
    1); a warp of identity or shift rows never runs the general
    transform."""
    rng = np.random.default_rng(len(arm))
    n = 40 * CHUNK_ROWS + 5
    x = {"qci": rng.integers(0, 40, n).astype(np.int32)}
    qi, qo = chroma_arm_qps(x, arm)
    dc, ac = _levels(rng, n)
    _all_equal(dc, ac, qi, qo, 3)
    ran = 0
    for row0 in range(0, n, CHUNK_ROWS):
        rows = min(CHUNK_ROWS, n - row0)
        pad = CHUNK_ROWS - rows
        *_, gen = requant_chunk(
            np.pad(dc[row0:row0 + rows], ((0, pad), (0, 0))),
            np.pad(ac[row0:row0 + rows], ((0, pad), (0, 0), (0, 0))),
            np.pad(qi[row0:row0 + rows], (0, pad)),
            np.pad(qo[row0:row0 + rows], (0, pad)), rows)
        ran += gen
    # 41 chunks; with "chunks", chunk i is general when i % 7 is 2, 4 or
    # 6: 3 in each of five whole cycles, and chunks 37 and 39
    want = {"identity": 0, "shift": 0, "general": 41, "chunks": 17}
    assert ran == want[arm]


@pytest.mark.parametrize("s", [-40, -33, -32, -1, 0, 1, 15, 30, 31, 32, 33,
                               64, INT_MAX, INT_MIN])
def test_clamped_shifts_equal_torch_shifts(s):
    """The reformulations against torch's own int32 shifts: ``x >> s``
    is ``x >> rshift_amount(s)``, and ``(x * v) << s`` is ``x * shl(v,
    s)``."""
    rng = np.random.default_rng(abs(s) % 1000)
    x = np.concatenate([rng.integers(INT_MIN, INT_MAX, 200, endpoint=True),
                        [INT_MIN, INT_MAX, 0, -1, 1]]).astype(np.int32)
    v = rng.integers(0, 30, x.size).astype(np.int32)
    tx, tv = torch.from_numpy(x), torch.from_numpy(v)
    ts = torch.full_like(tx, s)
    np.testing.assert_array_equal((tx >> ts).numpy(),
                                  x.astype(np.int64) >> rshift_amount(s))
    np.testing.assert_array_equal(((tx * tv) << ts).numpy(),
                                  wrap(x.astype(np.int64) * shl(v, s)))


def test_hadamard_butterflies_equal_the_2x2_hadamard():
    rng = np.random.default_rng(5)
    x = rng.integers(INT_MIN, INT_MAX, (500, 4), endpoint=True)
    a, b, c, d = (x[:, i] for i in range(4))
    want = np.stack([a + b + c + d, a - b + c - d, a + b - c - d,
                     a - b - c + d], -1)
    np.testing.assert_array_equal(hadamard4(x), wrap(want))


@pytest.mark.parametrize("n", range(1, 10))
def test_chroma_leg_layout_is_16_byte_aligned(n):
    lay = hk.chroma_leg_layout(n)
    sizes = {"dc": 4 * n, "ac": 60 * n, "qpc_in": n, "qpc_out": n,
             "dc_out": 4 * n, "ac_out": 60 * n}
    order = ["dc", "ac", "qpc_in", "qpc_out", "dc_out", "ac_out"]
    for name in order:
        assert lay[name] % 4 == 0, (name, lay)
    for a, b in zip(order, order[1:]):
        assert lay[a] + sizes[a] <= lay[b], (a, b, lay)
    assert lay["in_words"] == lay["qpc_out"] + n
    assert lay["words"] == lay["ac_out"] + 60 * n
    # the outputs are read back as one run: dc' then ac'
    assert lay["ac_out"] == lay["dc_out"] + 4 * n
