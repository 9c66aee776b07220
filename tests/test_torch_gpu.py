"""Each CUDA kernel of the port held against its plain PyTorch version on
the card. Marked ``gpu``; without a CUDA card every test skips (decided in
the ``cuda`` fixture, never at import). Run on a card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: outputs whose float steps the kernel repeats op for op (the
projection without an activation) and every integer result (the TINT GEMM,
the LOP screen) must be bitwise; the serving kernels' f32 outputs agree to
rtol = atol = 2e-5 (online vs. one-pass softmax, other exp/tanh code), the
standalone attention kernels' to rtol = atol = 1e-4 (the reference's own
kernel-test tolerance).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as plain

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dev(rng_arrays, dev):
    return [torch.from_numpy(np.array(a)).to(dev) for a in rng_arrays]


@pytest.mark.parametrize("m,k,n,bias,act", [
    (4, 3200, 9600, False, None), (128, 3200, 3200, False, None),
    (4, 8640, 3200, False, None), (1, 64, 48, True, None),
    (33, 96, 40, True, "silu"), (9, 128, 64, False, "gelu"),
    # k above the former 12,400 cap
    (4, 13312, 256, False, None), (128, 13312, 320, True, None),
    # m at the 16- and 128-row tile edges, and a whole 1326-token prompt
    (16, 3200, 384, False, None), (17, 256, 200, True, "silu"),
    (129, 512, 96, False, None), (1326, 3200, 3200, False, None),
    # odd n (byte copies of the packed rows), k no multiple of 16
    (5, 256, 13, True, "gelu"), (128, 3200, 9601, False, None),
    (7, 100, 64, False, None),
    # the squared-relu epilogue: relu(y)·relu(y), bitwise in f32
    (4, 3200, 3200, False, "squared_relu"),
    (33, 96, 40, True, "squared_relu")])
def test_qlinear_kernel_matches_plain(cuda, m, k, n, bias, act):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    gamma = rng.uniform(0.01, 0.05, (n,)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) * 0.1
    x, packed, gamma, b = _dev((x, packed, gamma, b), cuda)
    b = b if bias else None
    got = ops.qlinear_fused(x, packed, gamma[None], b, act=act)
    want = plain.qlinear_ref(x, packed, gamma[None], b, act=act)
    torch.cuda.synchronize()
    if act in (None, "squared_relu"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


def _ffn_args(rng, m, d, f, gated, every_byte=False):
    width = 2 * f if gated else f
    x = rng.standard_normal((m, d)).astype(np.float32)
    if every_byte:
        gu = (np.arange(d // 4 * width) % 256).astype(np.uint8).reshape(
            d // 4, width)
        down = (np.arange(f // 4 * d) % 256).astype(np.uint8).reshape(
            f // 4, d)
    else:
        gu = rng.integers(0, 256, (d // 4, width)).astype(np.uint8)
        down = rng.integers(0, 256, (f // 4, d)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (1, width)).astype(np.float32)
    ds = np.full((1, 1), 0.02, np.float32)
    return x, gu, gs, down, ds


def _ffn_plain(args, d, gated, act):
    return plain.ffn_fused_ref(args[0], args[1], args[2], args[3],
                               args[4].expand(1, d), gated=gated, act=act)


@pytest.mark.parametrize("m,d,f,gated,act", [
    (4, 3200, 8640, True, "silu"), (128, 3200, 8640, True, "silu"),
    # f above the former 12,400 cap (mistral-nemo, qwen1.5-32b) on a
    # narrow d
    (4, 256, 14336, True, "silu"), (128, 256, 27392, True, "silu"),
    # f no multiple of 64 (a partial gate‖up tile; 4-byte copies)
    (16, 256, 1000, True, "silu"), (17, 512, 1004, True, "silu"),
    # the ungated gelu FFN; m past the tile edges and a whole prompt
    (9, 256, 512, False, "gelu"), (129, 320, 640, True, "silu"),
    (1326, 256, 512, True, "silu"),
    # the squared-relu epilogue, gated and ungated
    (4, 3200, 8640, True, "squared_relu"),
    (17, 256, 512, False, "squared_relu")])
def test_ffn_kernel_matches_plain(cuda, m, d, f, gated, act):
    rng = np.random.default_rng(m + f)
    args = _dev(_ffn_args(rng, m, d, f, gated), cuda)
    got = ops.ffn_fused(*args, gated=gated, act=act)
    want = _ffn_plain(args, d, gated, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("m", [5, 9])
def test_verify_width_projections_bitwise(cuda, m):
    """#1 and #2 at the speculative verify chunk's m = γ+1 (γ 4 and 8), at
    bitnet-3b's widths, bitwise their plain versions."""
    rng = np.random.default_rng(m)
    for k, n in ((3200, 9600), (3200, 3200)):
        x = rng.standard_normal((m, k)).astype(np.float32)
        packed = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
        gamma = rng.uniform(0.01, 0.05, (1, n)).astype(np.float32)
        x, packed, gamma = _dev((x, packed, gamma), cuda)
        got = ops.qlinear_fused(x, packed, gamma)
        want = plain.qlinear_ref(x, packed, gamma)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, n)
    args = _dev(_ffn_args(rng, m, 3200, 8640, True), cuda)
    got = ops.ffn_fused(*args, gated=True, act="silu")
    want = _ffn_plain(args, 3200, True, "silu")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [4, 128])
def test_qlinear_ffn_every_code_byte(cuda, m):
    """Packed streams holding every byte value 0..255, so code 3 (→ 0)
    meets every other code in every position of a byte, through the
    projection (bitwise) and the gate‖up and down stages of the FFN."""
    rng = np.random.default_rng(m)
    k, n = 3200, 320
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = (np.arange(k // 4 * n) % 256).astype(np.uint8).reshape(k // 4, n)
    gamma = rng.uniform(0.01, 0.05, (1, n)).astype(np.float32)
    x, packed, gamma = _dev((x, packed, gamma), cuda)
    got = ops.qlinear_fused(x, packed, gamma)
    assert torch.equal(got, plain.qlinear_ref(x, packed, gamma))
    d, f = 512, 1280
    args = _dev(_ffn_args(rng, m, d, f, True, every_byte=True), cuda)
    got = ops.ffn_fused(*args, gated=True, act="silu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _ffn_plain(args, d, True, "silu"), **TOL)


@pytest.mark.parametrize("m,k,n", [(4, 8640, 3200), (128, 3200, 3200)])
def test_qlinear_ffn_split_k_deterministic(cuda, m, k, n):
    """Two calls on the same inputs are bitwise equal where the GEMM
    splits k over a cluster of CTAs that sum their partial tiles: the
    projection, and the whole FFN (gate‖up split too at m = 4)."""
    from repro_torch.kernels.qlinear import launch_shape
    assert launch_shape(m, k, n)["split"] > 1
    rng = np.random.default_rng(k + n)
    x, packed, gamma = _dev((rng.standard_normal((m, k)).astype(np.float32),
                             rng.integers(0, 256, (k // 4, n)).astype(
                                 np.uint8),
                             rng.uniform(0.01, 0.05, (1, n)).astype(
                                 np.float32)), cuda)
    first = ops.qlinear_fused(x, packed, gamma)
    second = ops.qlinear_fused(x, packed, gamma)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, plain.qlinear_ref(x, packed, gamma))
    d, f = 3200, 8640
    if m == 4:
        assert launch_shape(m, d, f, gated=True)["split"] > 1
    args = _dev(_ffn_args(rng, m, d, f, True), cuda)
    first = ops.ffn_fused(*args, gated=True, act="silu")
    second = ops.ffn_fused(*args, gated=True, act="silu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _attn(rng, b, h, hkv, c, dh, m):
    return (rng.integers(-127, 128, (b, h, c, dh)).astype(np.int8),
            (rng.random((b, h, c)) * 0.1 + 0.01).astype(np.float32),
            rng.integers(-127, 128, (b, hkv, m, dh)).astype(np.int8),
            rng.integers(-127, 128, (b, hkv, m, dh)).astype(np.int8),
            (rng.random((b, hkv, m)) * 0.1 + 0.01).astype(np.float32),
            (rng.random((b, hkv, m)) * 0.1 + 0.01).astype(np.float32))


@pytest.mark.parametrize("b,h,hkv,c,dh,m,window,causal", [
    (1, 32, 32, 128, 100, 1664, 0, True), (2, 4, 2, 8, 32, 64, 12, True),
    (2, 4, 2, 8, 100, 64, 0, False),
    # GQA (rows g-major, G = 4), R = 148 not a multiple of 16, three lanes
    # at kv_len [156, 0, 119]: the empty lane is exact zero
    (3, 8, 2, 37, 100, 256, 0, True),
    # window 48 at dh 100: late rows' leading key tiles fully masked
    (1, 4, 4, 64, 100, 512, 48, True), (3, 8, 2, 24, 100, 300, 40, True),
    (2, 4, 2, 13, 64, 96, 0, True), (3, 8, 2, 20, 128, 128, 0, False),
    # the speculative verify chunk: R = γ+1 rows (no multiple of the row
    # tile) at a start that is no block multiple
    (1, 32, 32, 2, 100, 1664, 0, True), (1, 32, 32, 5, 100, 1664, 0, True),
    (1, 32, 32, 9, 100, 1664, 0, True), (2, 32, 32, 5, 100, 1664, 0, True)])
def test_prefill_kernel_matches_plain(cuda, b, h, hkv, c, dh, m, window,
                                      causal):
    rng = np.random.default_rng(dh + m)
    arrs = _dev(_attn(rng, b, h, hkv, c, dh, m), cuda)
    kvl = m - 100 if m > 200 else m - 24
    kv_len = torch.tensor([kvl, 0, kvl - 37][:b], dtype=torch.int32,
                          device=cuda)
    kw = dict(q_offset=kvl - c, causal=causal, window=window)
    got = ops.prefill_attention(*arrs, kv_len, **kw)
    want = plain.prefill_attention_ref(*arrs, kv_len, kvl - c,
                                       causal=causal, window=window,
                                       softmax_scale=dh ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    if b > 1:
        assert not got[1].any()


@pytest.mark.parametrize("c,dh,start", [
    (40, 100, 24), (48, 100, 200), (256, 100, 72),
    (40, 32, 8), (48, 32, 88), (256, 32, 328)])
def test_prefill_kernel_chunk_widths(cuda, c, dh, start):
    """#3 at the chunk widths ``--chunk-tokens`` serves (40, 48 and 256,
    which spans two LOP blocks of 128), at starts that are multiples of
    neither its 16-row nor its 32-key tile, GQA (G 4); the second lane's
    keys end 7 rows into the chunk, as a padded tail chunk's do."""
    rng = np.random.default_rng(c + dh + start)
    m = 1664 if dh == 100 else 640
    arrs = _dev(_attn(rng, 2, 8, 2, c, dh, m), cuda)
    kv_len = torch.tensor([start + c, start + 7], dtype=torch.int32,
                          device=cuda)
    got = ops.prefill_attention(*arrs, kv_len, q_offset=start, causal=True)
    want = plain.prefill_attention_ref(*arrs, kv_len, start, causal=True,
                                       window=0, softmax_scale=dh ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("h,hkv,c,window", [
    (32, 32, 128, 0), (8, 2, 40, 0), (32, 32, 128, 48), (8, 2, 40, 48)])
def test_prefill_chunked_bitwise_whole_on_card(cuda, h, hkv, c, window):
    rng = np.random.default_rng(11)
    s, m = 300, 1664
    qi, qsc, ki, vi, ks, vs = _dev(_attn(rng, 1, h, hkv, 384, 100, m), cuda)
    whole = ops.prefill_attention(qi[:, :, :s], qsc[:, :, :s], ki, vi, ks, vs,
                                  torch.tensor([s], dtype=torch.int32,
                                               device=cuda), window=window)
    for start in range(0, s, c):
        part = ops.prefill_attention(
            qi[:, :, start:start + c], qsc[:, :, start:start + c], ki, vi, ks,
            vs, torch.tensor([start + c], dtype=torch.int32, device=cuda),
            q_offset=start, window=window)
        n = min(c, s - start)
        assert torch.equal(part[:, :, :n], whole[:, :, start:start + n])


def _decode(rng, b, h, hkv, m, dh):
    from repro_torch.core.lop import lop_features, pack_features
    arrs = [rng.integers(-60, 61, (b, h, dh)).astype(np.int8),
            rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32),
            rng.integers(-60, 61, (b, hkv, m, dh)).astype(np.int8),
            rng.integers(-60, 61, (b, hkv, m, dh)).astype(np.int8),
            rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32),
            rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32)]
    arrs.append(pack_features(lop_features(torch.from_numpy(arrs[2])))
                .numpy())
    return arrs


# bitnet-3b's lane shape, M 1664 and block 128, splits into 7 CTAs a lane
# (shares of 2 blocks); M 8192 into 8 (shares of 8)
@pytest.mark.parametrize("b,h,hkv,m,dh,block,k_keep,window,lens", [
    (4, 32, 32, 1664, 100, 128, 2, 0, None),
    (4, 32, 32, 1664, 100, 128, 2, 300, None),
    (3, 8, 2, 128, 32, 16, 3, 0, None),
    # new_len at the split's edges: 1, block − 1, block, block + 1, one
    # CTA's whole share (2 blocks), M
    (6, 8, 8, 1664, 100, 128, 2, 0, (1, 127, 128, 129, 256, 1664)),
    # more blocks than a CTA's share; 1024 fills exactly one share
    (4, 8, 8, 8192, 100, 128, 3, 0, (8192, 1024, 1025, 5000)),
    # G = 4 over hkv 8, as GQA configs call it (d 100 and 128)
    (3, 32, 8, 1664, 100, 128, 2, 0, (1600, 0, 700)),
    (3, 32, 8, 1664, 128, 128, 2, 0, (1600, 129, 700)),
    # window intervals straddling the share boundaries at 256, 512, 1024
    (4, 8, 8, 1664, 100, 128, 2, 200, (300, 600, 1100, 1664)),
    # the speculative draft's pinched budget, k_keep 1
    (4, 32, 32, 1664, 100, 128, 1, 0, None),
    (6, 8, 8, 1664, 100, 128, 1, 0, (1, 127, 128, 129, 256, 1664))])
def test_decode_kernel_matches_plain(cuda, b, h, hkv, m, dh, block, k_keep,
                                     window, lens):
    rng = np.random.default_rng(m + dh)
    arrs = _dev(_decode(rng, b, h, hkv, m, dh), cuda)
    lens = lens or [m - 64, 0, m // 3, block + 1][:b]
    new_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(block=block, k_keep=k_keep, window=window)
    ops.reset_launch_counts()
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=dh ** -0.5, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_decode_attention"] == 1
    torch.testing.assert_close(got, want, **TOL)
    for lane, n in enumerate(lens):
        if n == 0:
            assert not got[lane].any()               # retired lane → zero


@pytest.mark.parametrize("dh,g,window,m,lens", [
    (dh, g, window, 1664, None)
    for dh in (32, 100) for g in (1, 4) for window in (0, 256)] + [
    # new_len at the split's edges (shares of 2 blocks of 128)
    (100, 1, 0, 1664, (1, 127, 128, 129)), (100, 4, 0, 1664, (256, 257, 1664, 0)),
    (128, 4, 0, 1664, (1, 255, 256, 1664)),
    # more blocks than a CTA's share (M 8192: shares of 8 blocks)
    (100, 1, 0, 8192, (8192, 1024, 1025, 0)), (100, 4, 0, 8192, (7000, 1, 4095, 8191)),
    # window intervals straddling the share boundaries
    (100, 1, 200, 1664, (300, 600, 1100, 1664)),
    (100, 4, 1000, 8192, (1500, 5000, 8192, 1023))])
def test_dense_decode_kernel_matches_plain(cuda, dh, g, window, m, lens):
    # the M 1664 cases keep the seed they had before M was a parameter
    rng = np.random.default_rng(dh * 10 + g + window + (m - 1664))
    b, hkv, block = 4, 8, 128
    arrs = _dev(_decode(rng, b, g * hkv, hkv, m, dh), cuda)
    lens = lens or (m - 64, 0, 700, block + 1)
    new_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(block=block, k_keep=2, window=window, use_lop=False)
    ops.reset_launch_counts()
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=dh ** -0.5, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_dense_decode_attention"] == 1
    assert ops.launch_counts()["fused_decode_attention"] == 0
    torch.testing.assert_close(got, want, **TOL)
    for lane, n in enumerate(lens):
        if n == 0:
            assert not got[lane].any()               # retired lane → zero


def test_dense_decode_lanes_independent_bitwise(cuda):
    """A lane's output is the same bits whether the other lanes are live
    or retired (new_len 0): the recovery retry runs one lane alone."""
    rng = np.random.default_rng(5)
    b, h, m, dh = 4, 32, 1664, 100
    arrs = _dev(_decode(rng, b, h, h, m, dh), cuda)
    full = torch.tensor([1500, 300, 900, 1663], dtype=torch.int32,
                        device=cuda)
    kw = dict(block=128, k_keep=2, use_lop=False)
    together = ops.decode_attention(*arrs, full, **kw)
    for lane in range(b):
        alone = torch.where(torch.arange(b, device=cuda) == lane, full, 0)
        out = ops.decode_attention(*arrs, alone.to(torch.int32), **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[lane], together[lane]), lane


def test_lop_decode_lanes_independent_bitwise(cuda):
    """#4's twin of the test above: a lane's bits do not depend on the
    other lanes' new_len, whatever CTA of its cluster each share lands on."""
    rng = np.random.default_rng(6)
    b, h, m, dh = 4, 32, 1664, 100
    arrs = _dev(_decode(rng, b, h, h, m, dh), cuda)
    full = torch.tensor([1500, 300, 900, 1663], dtype=torch.int32,
                        device=cuda)
    kw = dict(block=128, k_keep=2)
    together = ops.decode_attention(*arrs, full, **kw)
    for lane in range(b):
        alone = torch.where(torch.arange(b, device=cuda) == lane, full, 0)
        out = ops.decode_attention(*arrs, alone.to(torch.int32), **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[lane], together[lane]), lane


@pytest.mark.parametrize("use_lop", [True, False])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_lane_bitwise_across_batch_sizes(cuda, use_lop, g):
    """A lane's output in a B = 1 call is bitwise its row in the B = 4
    call (the scheduler and lockstep decode one request at different B):
    the split depends on the lane's shape alone."""
    from repro_torch.kernels.decode_attention import launch_shape
    rng = np.random.default_rng(7 + g)
    b, hkv, m, dh, block = 4, 8, 1664, 100, 128
    arrs = _dev(_decode(rng, b, g * hkv, hkv, m, dh), cuda)
    lens = torch.tensor([1600, 129, 700, 1200], dtype=torch.int32,
                        device=cuda)
    kw = dict(block=block, k_keep=2, use_lop=use_lop)
    batched = ops.decode_attention(*arrs, lens, **kw)
    for lane in range(b):
        one = [a[lane:lane + 1].contiguous() for a in arrs]
        out = ops.decode_attention(*one, lens[lane:lane + 1].contiguous(),
                                   **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[0], batched[lane]), lane
    shapes = [launch_shape(n * hkv, g, m, dh, block, k_keep=2, lop=use_lop)
              for n in (1, b)]
    assert shapes[0]["split"] == shapes[1]["split"] == 7
    assert shapes[1]["ctas"] == b * shapes[0]["ctas"]


@pytest.mark.parametrize("use_lop", [True, False])
def test_decode_kernel_repeat_bitwise(cuda, use_lop):
    """Two calls on the same inputs give the same bits (no atomics; the
    cluster merges its CTAs in a fixed order)."""
    rng = np.random.default_rng(8)
    b, h, hkv, m, dh = 4, 32, 8, 8192, 100
    arrs = _dev(_decode(rng, b, h, hkv, m, dh), cuda)
    lens = torch.tensor([8000, 1, 4100, 2047], dtype=torch.int32,
                        device=cuda)
    kw = dict(block=128, k_keep=3, window=3000, use_lop=use_lop)
    first = ops.decode_attention(*arrs, lens, **kw)
    second = ops.decode_attention(*arrs, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# a 2048-slot cache cut into n shards; shard r holds global rows
# [r·M/n, (r + 1)·M/n); lane 3 retired, lane 1 (new_len 100) leaves every
# shard past the first empty, lane 2 (1100) ends inside shard 1 of 2
SHARD_LENS = (2000, 100, 1100, 0)


def _shard_call(arrs, lens, n, r, *, m, block=128, k_keep=2, window=0,
                mode="lop", plain_version=False):
    new_len = torch.tensor(lens, dtype=torch.int32, device=arrs[0].device)
    kw = dict(block=block, k_keep=k_keep, window=window,
              use_lop=mode != "dense", shared_select=mode == "lop-shared",
              pos_offset=r * (m // n), return_stats=True)
    if plain_version:
        return plain.decode_attention_ref(
            *arrs, new_len, softmax_scale=arrs[0].shape[-1] ** -0.5, **kw)
    return ops.decode_attention(*arrs, new_len, **kw)


@pytest.mark.parametrize("mode", ["lop", "lop-shared", "dense"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("n,r,window", [
    (1, 0, 0), (2, 0, 0), (2, 1, 0), (4, 1, 0), (4, 3, 0),
    # a window across shard 0 / shard 1's edge (lane 2: [800, 1100))
    (2, 0, 300), (2, 1, 300), (4, 2, 300)])
def test_decode_stats_modes_match_plain(cuda, mode, g, n, r, window):
    """#4 (per head or one candidate set a kv head) and #5 on one shard of
    a token-sharded cache (pos_offset), returning (out, m, ℓ): within
    2e-5 of the plain version (a different candidate set would be far
    off), and an empty row exactly m = −1e30, ℓ = 0, out = 0."""
    rng = np.random.default_rng(100 * n + 10 * r + g + window)
    b, hkv, m, dh = 4, 8, 2048, 100
    arrs = _dev(_decode(rng, b, g * hkv, hkv, m // n, dh), cuda)
    ops.reset_launch_counts()
    got = _shard_call(arrs, SHARD_LENS, n, r, m=m, window=window, mode=mode)
    want = _shard_call(arrs, SHARD_LENS, n, r, m=m, window=window,
                       mode=mode, plain_version=True)
    torch.cuda.synchronize()
    name = ("fused_dense_decode_attention" if mode == "dense"
            else "fused_decode_attention")
    assert ops.launch_counts()[name] == 1
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **TOL)
    out, mx, l = got
    assert out.shape == (b, g * hkv, dh) and mx.shape == l.shape == (
        b, g * hkv, 1)
    offset = r * (m // n)
    for lane, nl in enumerate(SHARD_LENS):
        lo = max(nl - window, 0) if window else 0
        if nl <= offset or lo >= offset + m // n:
            assert not out[lane].any() and not l[lane].any(), lane
            assert (mx[lane] == -1e30).all(), lane


@pytest.mark.parametrize("use_lop", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_decode_stats_shards_merge_to_plain(cuda, use_lop, n):
    """The n shards' (out, m, ℓ), merged flash-decoding style in-process,
    equal the plain versions' merge within 2e-5."""
    rng = np.random.default_rng(40 + n)
    b, h, m, dh = 4, 32, 2048, 100
    arrs = _dev(_decode(rng, b, h, h, m, dh), cuda)
    mode = "lop" if use_lop else "dense"
    merged = []
    for plain_version in (False, True):
        parts = [_shard_call([a if i < 2 else  # q, q scales; then the cache
                              a[:, :, r * m // n:(r + 1) * m // n]
                              .contiguous() for i, a in enumerate(arrs)],
                             SHARD_LENS, n, r, m=m, mode=mode,
                             plain_version=plain_version)
                 for r in range(n)]
        out, mx, l = (torch.stack(t) for t in zip(*parts))
        w = torch.exp(mx - mx.amax(0, keepdim=True))
        lw = (l * w).sum(0)
        merged.append((out * (l * w)).sum(0) / torch.clamp_min(lw, 1e-20))
    torch.cuda.synchronize()
    torch.testing.assert_close(merged[0], merged[1], **TOL)
    assert not merged[0][3].any()                    # the retired lane


@pytest.mark.parametrize("use_lop", [True, False])
def test_shared_select_one_row_bitwise_per_head(cuda, use_lop):
    """At G = 1 one candidate set a kv head is per-head selection: the
    same bits, stats included."""
    rng = np.random.default_rng(12)
    arrs = _dev(_decode(rng, 4, 32, 32, 1024, 100), cuda)
    outs = [_shard_call(arrs, SHARD_LENS, 2, 1, m=2048, window=300,
                        mode=mode if use_lop else "dense")
            for mode in ("lop", "lop-shared")]
    torch.cuda.synchronize()
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


def test_decode_stats_rejects_unaligned_offset(cuda):
    rng = np.random.default_rng(0)
    arrs = _dev(_decode(rng, 1, 4, 4, 256, 32), cuda)
    new_len = torch.tensor([200], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.decode_attention(*arrs, new_len, block=128, k_keep=1,
                             pos_offset=64)


SP_MAX_LEN = 255             # capacity 256: 4 blocks of 32 a rank


def sp_rank_on_card(mesh, inputs, prompts, device="cuda"):
    """One rank of the 2-rank SP check: its shard of a random cache layer
    through ``sp_decode_attention``, then 6 greedy steps of
    ``bitnet-3b-reduced`` (seed 0) with ``serve_step(sp_axes=...)``, with
    and without ``use_ffn_tp``, all on ``device``. → numpy results."""
    from contextlib import nullcontext
    from repro_torch.configs import get_config
    from repro_torch.distributed.partitioning import use_mesh
    from repro_torch.distributed.sp_decode import sp_decode_attention
    from repro_torch.distributed.tp_ffn import use_ffn_tp
    from repro_torch.serving import engine
    from repro_torch.serving.api import PooledEngine
    dev = torch.device(device)
    cfg = get_config("bitnet-3b-reduced")
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in inputs.items()}
    m = t["k"].shape[2]
    n = mesh.size("model")
    rows = (slice(0, m) if mesh.local else
            slice(mesh.rank("model") * m // n, (mesh.rank("model") + 1) * m // n))
    res = {}
    with use_mesh(mesh):
        for keep in (1.0, 0.25):
            cl = {k: t[k][:, :, rows].clone() for k in
                  ("k", "v", "k_scale", "v_scale", "feat")}
            out, cl = sp_decode_attention(
                cfg.replace(lop_keep=keep), t["qi"], t["qsc"], t["ki"],
                t["vi"], t["ksc"], t["vsc"], t["feat_new"], cl, t["lengths"],
                window=0, use_lop=True, sp_axes=("model",))
            res[f"out/{keep}"] = out.cpu().numpy()
            res[f"k/{keep}"] = cl["k"].cpu().numpy()
        eng = PooledEngine.from_seed(cfg, seed=0, max_len=SP_MAX_LEN,
                                     device=dev)
        for tp in (False, True):
            logits, cache = eng.prefill(prompts)
            tok = logits.argmax(-1)
            toks = [tok]
            cache = engine.shard_cache(cache)
            with use_ffn_tp() if tp else nullcontext():
                for _ in range(5):
                    logits, cache = engine.serve_step(
                        cfg, eng.qp, cache, tok[:, None], sp_axes=("model",))
                    tok = logits.argmax(-1)
                    toks.append(tok)
            res[f"tokens/{tp}"] = torch.stack(toks, 1).cpu().numpy()
    return res


def test_sp_decode_two_gloo_ranks_on_card(cuda):
    """2 ranks in a gloo group on one card (all_reduce on CUDA tensors):
    the cache shards concatenated and every output bitwise the
    single-process mesh's run on the card (a sum of two is the same in
    either order), and at lop_keep 1 within 1e-3 (relative) of the local
    dense decode, the reference's own bound."""
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.launch.mesh import local_mesh, spawn_ranks
    from repro_torch.serving.engine import lop_decode_attention
    from repro_torch.configs import get_config
    rng = np.random.default_rng(3)
    b, h, dh, m = 4, 4, 32, 512
    inputs = dict(
        qi=rng.integers(-60, 61, (b, h, dh)).astype(np.int8),
        qsc=rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32),
        ki=rng.integers(-60, 61, (b, h, dh)).astype(np.int8),
        vi=rng.integers(-60, 61, (b, h, dh)).astype(np.int8),
        ksc=rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32),
        vsc=rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32),
        k=rng.integers(-60, 61, (b, h, m, dh)).astype(np.int8),
        v=rng.integers(-60, 61, (b, h, m, dh)).astype(np.int8),
        k_scale=rng.uniform(0.005, 0.02, (b, h, m)).astype(np.float32),
        v_scale=rng.uniform(0.005, 0.02, (b, h, m)).astype(np.float32),
        lengths=np.asarray([472, 100, 300, 511], np.int32))
    inputs["feat"] = pack_features(lop_features(torch.from_numpy(
        inputs["k"]))).numpy()
    inputs["feat_new"] = pack_features(lop_features(torch.from_numpy(
        inputs["ki"]))).numpy()
    prompts = rng.integers(0, 512, (2, 100)).astype(np.int32)
    ranks = spawn_ranks("test_torch_gpu:sp_rank_on_card", 2,
                        (inputs, prompts), timeout=600)
    local = sp_rank_on_card(local_mesh((2,)), inputs, prompts)
    for key, want in local.items():
        if key.startswith("k/"):                     # the cache shards
            got = np.concatenate([r[key] for r in ranks], 2)
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            for r in ranks:
                np.testing.assert_array_equal(r[key], want, err_msg=key)
    # at lop_keep 1 the merge is exact attention up to rounding
    t = {k: torch.from_numpy(np.array(v)).to(cuda) for k, v in
         inputs.items()}
    cl = {k: t[k].clone() for k in ("k", "v", "k_scale", "v_scale", "feat")}
    lanes = torch.arange(b, device=cuda)
    pos = t["lengths"].long()
    for key, val in (("k", t["ki"]), ("v", t["vi"]),
                     ("k_scale", t["ksc"][..., 0]),
                     ("v_scale", t["vsc"][..., 0]), ("feat", t["feat_new"])):
        cl[key][lanes, :, pos] = val
    dense = lop_decode_attention(get_config("bitnet-3b-reduced"), t["qi"],
                                 t["qsc"], cl, t["lengths"] + 1, window=0,
                                 use_lop=False).cpu().numpy()
    err = np.abs(local["out/1.0"] - dense).max()
    assert err / np.abs(dense).max() < 1e-3


GLOO_PROBE = ("all_reduce", "broadcast", "all_gather",
              "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all", "all_to_all_single", "isend_irecv")


def gloo_probe_rank(mesh, op):
    """One rank of 2 running gloo's ``op`` on CUDA tensors as they are
    (no host copy) → the result on the host."""
    import torch.distributed as dist
    r = mesh.rank("model")
    x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * r
    if op == "all_reduce":
        dist.all_reduce(x)
        return x.cpu()
    if op == "broadcast":
        dist.broadcast(x, 0)
        return x.cpu()
    if op == "all_gather":
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        return torch.cat(out).cpu()
    if op == "all_gather_into_tensor":
        out = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(out, x)
        return out.cpu()
    if op == "reduce_scatter_tensor":
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(out, x)
        return out.cpu()
    if op == "all_to_all":
        out = [torch.empty(2, device="cuda") for _ in range(2)]
        dist.all_to_all(out, list(x.split(2)))
        return torch.cat(out).cpu()
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out.cpu()
    out = torch.empty_like(x)
    reqs = [dist.isend(x, 1 - r), dist.irecv(out, 1 - r)]
    for q in reqs:
        q.wait()
    return out.cpu()


def _probe_want(op):
    a, b = torch.arange(4.), torch.arange(4.) + 10
    return {"all_reduce": [a + b] * 2, "broadcast": [a, a],
            "all_gather": [torch.cat([a, b])] * 2,
            "all_gather_into_tensor": [torch.cat([a, b])] * 2,
            "reduce_scatter_tensor": [(a + b)[:2], (a + b)[2:]],
            "all_to_all": [torch.cat([a[:2], b[:2]]),
                           torch.cat([a[2:], b[2:]])],
            "all_to_all_single": [torch.cat([a[:2], b[:2]]),
                                  torch.cat([a[2:], b[2:]])],
            "isend_irecv": [b, a]}[op]


def gloo_wrappers_rank(mesh):
    """The port's collectives on CUDA tensors over 2 gloo ranks."""
    from repro_torch.distributed import partitioning as part
    r = mesh.rank("model")
    x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * r
    out = {"psum": part.psum(x, "model", mesh),
           "pmax": part.pmax(x, "model", mesh),
           "all_gather": part.all_gather(x, "model", 0, mesh),
           "all_to_all": part.all_to_all(x.reshape(2, 2), "model", 0, 0,
                                         mesh),
           "ppermute": part.ppermute(x, "model", mesh)}
    assert all(v.is_cuda for v in out.values())
    return {k: v.cpu() for k, v in out.items()}


def test_gloo_cuda_collectives_probe(cuda):
    """Which gloo collectives take CUDA tensors as they are (each probed
    in its own 2-rank group, a crash or a hang counting as no), and the
    port's wrappers on CUDA tensors: those of
    ``partitioning.GLOO_CUDA_OPS`` direct, the ring hop through explicit
    host copies."""
    from repro_torch.distributed.partitioning import GLOO_CUDA_OPS
    from repro_torch.launch.mesh import spawn_ranks
    takes = {}
    for op in GLOO_PROBE:
        try:
            got = spawn_ranks("test_torch_gpu:gloo_probe_rank", 2, (op,),
                              timeout=120)
            takes[op] = all(torch.equal(g, w)
                            for g, w in zip(got, _probe_want(op)))
        except Exception as exc:                   # a crash, a hang
            takes[op] = f"no ({type(exc).__name__})"
    print(f"gloo on CUDA tensors: {takes}")
    assert all(takes[op] is True for op in GLOO_CUDA_OPS)
    ranks = spawn_ranks("test_torch_gpu:gloo_wrappers_rank", 2, timeout=300)
    a, b = torch.arange(4.), torch.arange(4.) + 10
    for r, res in enumerate(ranks):
        assert torch.equal(res["psum"], a + b)
        assert torch.equal(res["pmax"], b)
        assert torch.equal(res["all_gather"], torch.cat([a, b]))
        assert torch.equal(res["all_to_all"].flatten(),
                           torch.cat([a, b]).reshape(2, 2, 2)[:, r]
                           .flatten())
        assert torch.equal(res["ppermute"], [b, a][r])


def test_cuda_tensor_never_takes_plain_path(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, device=cuda)
    packed = torch.randint(0, 256, (16, 32), dtype=torch.uint8, device=cuda)
    ops.qlinear_fused(x, packed, torch.full((1, 1), 0.02, device=cuda))
    assert ops.launch_counts()["fused_qlinear"] == 1


# ---------------------------------------------------------------------------
# the four standalone kernels
# ---------------------------------------------------------------------------

TOL_STANDALONE = dict(rtol=1e-4, atol=1e-4)


def _launched(name):
    """Assert that the block ran kernel ``name`` exactly once."""
    class _Count:
        def __enter__(self):
            ops.reset_launch_counts()

        def __exit__(self, *exc):
            if exc[0] is None:
                assert ops.launch_counts()[name] == 1
    return _Count()


@pytest.mark.parametrize("m,k,n", [
    (4, 3200, 9600), (128, 3200, 3200), (4, 8640, 3200), (128, 3200, 17280),
    (7, 100, 13), (33, 96, 40), (1, 4, 1),
    # k above the old 13,952 cap
    (4, 16384, 64), (128, 27392, 40), (16, 49152, 24),
    # k no multiple of 16 or 32 (4-byte row copies, a partial last stage)
    (5, 100, 64), (128, 3204, 256),
    # m across the 16- and 128-row tiles
    (17, 256, 128), (129, 512, 96), (200, 1024, 160),
    # n no multiple of the 128-column tile (odd n: byte copies)
    (4, 3200, 13), (128, 3200, 9601)])
def test_ternary_matmul_kernel_matches_plain(cuda, m, k, n):
    from repro_torch.core.ternary import TernaryWeight
    rng = np.random.default_rng(m + k + n)
    x, packed = _dev((rng.integers(-127, 128, (m, k)).astype(np.int8),
                      rng.integers(0, 256, (k // 4, n)).astype(np.uint8)),
                     cuda)
    tw = TernaryWeight(packed, torch.ones((1, 1), device=cuda), (k, n))
    with _launched("ternary_matmul"):
        got = ops.ternary_matmul(x, tw)
    want = plain.ternary_matmul_ref(x, packed, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("m", [4, 128])
def test_ternary_matmul_every_code_byte(cuda, m):
    """A packed stream holding every byte value 0..255, so code 3 (→ 0)
    meets every other code in every position of a byte."""
    from repro_torch.core.ternary import TernaryWeight
    rng = np.random.default_rng(m)
    k, n = 3200, 320
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    packed = (np.arange(k // 4 * n) % 256).astype(np.uint8).reshape(k // 4, n)
    x, packed = _dev((x, packed), cuda)
    tw = TernaryWeight(packed, torch.ones((1, 1), device=cuda), (k, n))
    with _launched("ternary_matmul"):
        got = ops.ternary_matmul(x, tw)
    want = plain.ternary_matmul_ref(x, packed, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(4, 8640, 3200), (128, 3200, 3200)])
def test_ternary_matmul_split_k_deterministic(cuda, m, k, n):
    """Two calls on the same inputs are bitwise equal where the launch
    splits k over a cluster of CTAs that sum their partial tiles."""
    from repro_torch.kernels.ternary_matmul import (launch_shape,
                                                    ternary_matmul)
    assert launch_shape(m, k, n)["split"] > 1
    rng = np.random.default_rng(k + n)
    x, packed = _dev((rng.integers(-127, 128, (m, k)).astype(np.int8),
                      rng.integers(0, 256, (k // 4, n)).astype(np.uint8)),
                     cuda)
    first = ternary_matmul(x, packed)
    second = ternary_matmul(x, packed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, plain.ternary_matmul_ref(x, packed, k))


@pytest.mark.parametrize("m,label", [(4, "qkv"), (128, "qkv"), (4, "o"),
                                     (128, "o")])
def test_tint_chain_bitwise_fused_qlinear(cuda, m, label):
    """(ternary_matmul(quantize(x)) · x_scale) · γ == the fused projection,
    bitwise: per-column γ (QKV) and one scalar γ (O)."""
    from repro_torch.core.quantization import quantize
    from repro_torch.core.ternary import TernaryWeight
    rng = np.random.default_rng(m)
    d = 3200
    n = 3 * d if label == "qkv" else d
    gamma = (rng.uniform(0.01, 0.05, (1, n)) if label == "qkv"
             else np.full((1, 1), 0.03)).astype(np.float32)
    x, packed, gamma = _dev((rng.standard_normal((m, d)).astype(np.float32),
                             rng.integers(0, 256, (d // 4, n)).astype(
                                 np.uint8), gamma), cuda)
    xq = quantize(x)
    acc = ops.ternary_matmul(xq.values, TernaryWeight(packed, gamma, (d, n)))
    chain = acc.to(torch.float32) * xq.scale * gamma
    fused = ops.qlinear_fused(x, packed, gamma)
    torch.cuda.synchronize()
    assert torch.equal(chain, fused)


@pytest.mark.parametrize("lanes,g,m,d", [
    (128, 1, 1664, 100), (3, 12, 1000, 100), (1, 40, 2048, 128),
    (2, 9, 77, 64)])
def test_lop_scores_kernel_matches_plain(cuda, lanes, g, m, d):
    from repro_torch.core.lop import lop_features, pack_features
    rng = np.random.default_rng(lanes + g + m)
    q = rng.integers(-127, 128, (lanes, g, d)).astype(np.int8)
    k = rng.integers(-127, 128, (lanes, m, d)).astype(np.int8)
    q, k = _dev((q, k), cuda)
    feat = pack_features(lop_features(k))
    with _launched("lop_scores_kernel"):
        got = ops.lop_screen(q, feat)
    want = plain.lop_scores_ref(_pot(q), feat)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _pot(q):
    from repro_torch.core.lop import pot
    return pot(q)


# every packed byte value; m no multiple of the 128-token tile; rows of
# d/2 bytes (50 at d 100) so tiles and lanes start off 16-byte boundaries,
# and feat itself at a 4-byte (not 16-byte) offset; g to 40 (passes of 8,
# 4, 2, 1 rows); d 32 / 64 / 100 / 128
@pytest.mark.parametrize("lanes,g,m,d,offset", [
    (3, 1, 77, 100, 0), (5, 3, 1300, 100, 4), (2, 40, 1000, 128, 4),
    (4, 9, 257, 32, 0), (1, 17, 130, 64, 12), (7, 2, 1664, 100, 8),
    (2, 15, 129, 100, 0)])
def test_lop_scores_kernel_every_byte(cuda, lanes, g, m, d, offset):
    rng = np.random.default_rng(lanes * 1000 + g * 10 + d)
    q = torch.from_numpy(rng.integers(-127, 128, (lanes, g, d)).astype(
        np.int8)).to(cuda)
    n = lanes * m * (d // 2)
    raw = np.concatenate([np.arange(256, dtype=np.uint8),
                          rng.integers(0, 256, max(n - 256, 0)).astype(
                              np.uint8)])[:n]
    rng.shuffle(raw)
    flat = torch.zeros(n + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = torch.from_numpy(raw).to(cuda)
    feat = flat[offset:].view(lanes, m, d // 2)
    assert feat.data_ptr() % 16 == offset % 16
    with _launched("lop_scores_kernel"):
        got = ops.lop_screen(q, feat)
    want = plain.lop_scores_ref(_pot(q), feat)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)




@pytest.mark.parametrize("s,d,causal,window", [
    (1536, 100, True, 0), (512, 64, True, 128), (300, 100, False, 0),
    (257, 128, True, 100),
    # s not a multiple of the 32-token key tile
    (1000, 100, True, 0), (77, 32, True, 0), (203, 128, False, 0),
    # a window inside one tile, and one spanning three tiles
    (400, 100, True, 20), (600, 64, True, 80),
    # head dims 32 / 64 / 100 / 128
    (129, 32, True, 0), (640, 64, False, 0), (513, 128, True, 0)])
def test_flash_prefill_kernel_matches_plain(cuda, s, d, causal, window):
    rng = np.random.default_rng(s + d + window)
    arrs = _dev([rng.integers(-127, 128, (s, d)).astype(np.int8)
                 for _ in range(3)]
                + [rng.uniform(0.001, 0.02, (s, 1)).astype(np.float32)
                   for _ in range(3)], cuda)
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window=window)
    with _launched("int8_flash_prefill"):
        got = ops.flash_prefill(*arrs, **kw)
    want = plain.flash_prefill_ref(*arrs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL_STANDALONE)


@pytest.mark.parametrize("lanes,share,g,m,d,block,nb", [
    (128, 1, 1, 1664, 100, 128, 2), (6, 3, 6, 2048, 64, 128, 4),
    (16, 4, 8, 256, 32, 32, 8)])
def test_sparse_decode_kernel_matches_plain(cuda, lanes, share, g, m, d,
                                            block, nb):
    rng = np.random.default_rng(lanes + g + nb)
    n_cache = lanes // share
    q = rng.integers(-127, 128, (lanes, g, d)).astype(np.int8)
    qs = rng.uniform(0.001, 0.02, (lanes, g, 1)).astype(np.float32)
    kc = rng.integers(-127, 128, (n_cache, m, d)).astype(np.int8)
    vc = rng.integers(-127, 128, (n_cache, m, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (n_cache, m, 1)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (n_cache, m, 1)).astype(np.float32)
    bidx = rng.integers(0, m // block, (lanes, nb)).astype(np.int32)
    bidx[0, 0] = m // block + 3                  # clamped into the cache
    gate = (rng.random((lanes, nb)) < 0.8).astype(np.int32)
    gate[0] = 1
    end = rng.integers(1, block + 1, (lanes, nb)).astype(np.int32)
    start = np.minimum(rng.integers(0, block, (lanes, nb)), end - 1)
    start[0, -1], end[0, -1] = 5, 5              # gated, empty interval
    gate[1], start[1, 0], end[1, 0] = 0, 7, 7    # ... and nothing else live
    gate[1, 0] = 1
    gt = np.concatenate([gate, end, start.astype(np.int32)], axis=1)
    gt[-1, :nb] = 0                              # an empty lane
    args = _dev((q, kc, vc, qs, ks, vs, bidx, gt), cuda)
    kw = dict(block=block, softmax_scale=d ** -0.5)
    # lanes as [C, share]: the cache lanes are their leading dim
    lane_args = [a.reshape(n_cache, share, *a.shape[1:])
                 if i in (0, 3, 6, 7) else a for i, a in enumerate(args)]
    with _launched("sparse_decode_attention"):
        got = ops.sparse_decode(*lane_args, **kw).reshape(lanes, g, d)
    want = plain.sparse_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL_STANDALONE)
    assert not got[-1].any()


def sparse_decode_attention(*args, **kw):
    """The #9 wrapper itself: lanes flat, L a multiple of the C cache
    lanes (``ops.sparse_decode`` wants the cache lanes as a prefix)."""
    from repro_torch.kernels.int8_attention import sparse_decode_attention
    return sparse_decode_attention(*args, **kw)


def _sparse_lists(rng, lanes, share, g, m, d, nb):
    n_cache = lanes // share
    return [rng.integers(-127, 128, (lanes, g, d)).astype(np.int8),
            rng.integers(-127, 128, (n_cache, m, d)).astype(np.int8),
            rng.integers(-127, 128, (n_cache, m, d)).astype(np.int8),
            rng.uniform(0.001, 0.02, (lanes, g, 1)).astype(np.float32),
            rng.uniform(0.001, 0.02, (n_cache, m, 1)).astype(np.float32),
            rng.uniform(0.001, 0.02, (n_cache, m, 1)).astype(np.float32)]


# nb 9–16: shares of 2 list entries, 5–8 CTAs a lane, so a CTA folds more
# than one entry; duplicate indices, indices clamped from below and above,
# share > 1; lane 1 gated but every interval empty (across its CTAs: the
# mean of its V), lane 2 every gate 0 (exact zero)
@pytest.mark.parametrize("lanes,share,g,m,d,block,nb", [
    (8, 1, 1, 1664, 100, 128, 9), (12, 4, 1, 2048, 100, 128, 16),
    (6, 3, 4, 1024, 64, 64, 12), (8, 2, 2, 4096, 128, 128, 13),
    (9, 3, 3, 512, 32, 32, 10)])
def test_sparse_decode_kernel_long_lists(cuda, lanes, share, g, m, d, block,
                                         nb):
    rng = np.random.default_rng(lanes * 100 + nb)
    arrs = _sparse_lists(rng, lanes, share, g, m, d, nb)
    bidx = rng.integers(0, m // block, (lanes, nb)).astype(np.int32)
    bidx[0, 1] = bidx[0, 0]                      # a duplicate
    bidx[0, 2], bidx[0, 3] = -4, m // block + 9  # clamped to 0 and the last
    gate = (rng.random((lanes, nb)) < 0.75).astype(np.int32)
    gate[0] = 1
    end = rng.integers(1, block + 1, (lanes, nb)).astype(np.int32)
    start = np.minimum(rng.integers(0, block, (lanes, nb)), end - 1)
    start[1], end[1], gate[1] = 7, 7, 1          # nothing live: mean of V
    gate[2] = 0                                  # exact zero
    gt = np.concatenate([gate, end, start.astype(np.int32)], axis=1)
    q, kc, vc, qs, ks, vs, bidx, gt = _dev(arrs + [bidx, gt], cuda)
    kw = dict(block=block, softmax_scale=d ** -0.5)
    with _launched("sparse_decode_attention"):
        got = sparse_decode_attention(q, kc, vc, qs, ks, vs, bidx, gt, **kw)
    want = plain.sparse_decode_attention_ref(q, kc, vc, qs, ks, vs, bidx,
                                             gt, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL_STANDALONE)
    assert not got[2].any()
    # lane 1 = the mean over its gated list entries of the dequantized V
    rows = torch.cat([torch.arange(b * block, (b + 1) * block, device=cuda)
                      for b in bidx[1].clamp(0, m // block - 1).tolist()])
    mean = (vc[1 // share, rows].double() * vs[1 // share, rows]).mean(0)
    torch.testing.assert_close(got[1].double(), mean.expand(g, d),
                               **TOL_STANDALONE)
    shape = _sparse_shape(lanes, g, d, block, nb)
    assert shape["share"] == 2 and shape["split"] == -(-nb // 2)


def _sparse_shape(lanes, g, d, block, nb):
    from repro_torch.kernels.int8_attention import sparse_decode_launch_shape
    return sparse_decode_launch_shape(lanes, g, d, block, nb)


@pytest.mark.parametrize("g,nb", [(1, 2), (1, 12), (3, 9)])
def test_sparse_decode_lanes_independent_bitwise(cuda, g, nb):
    """A lane's output is bitwise the same whatever the other lanes' block
    lists and gates hold, and from one call to the next."""
    rng = np.random.default_rng(40 + nb)
    lanes, share, m, d, block = 16, 2, 1664, 100, 128
    arrs = _dev(_sparse_lists(rng, lanes, share, g, m, d, nb), cuda)
    kw = dict(block=block, softmax_scale=d ** -0.5)

    def lists(seed):
        r = np.random.default_rng(seed)
        bidx = r.integers(0, m // block, (lanes, nb)).astype(np.int32)
        end = r.integers(1, block + 1, (lanes, nb))
        start = np.minimum(r.integers(0, block, (lanes, nb)), end - 1)
        gate = (r.random((lanes, nb)) < 0.7).astype(np.int32)
        return bidx, np.concatenate([gate, end, start], axis=1).astype(
            np.int32)
    bidx, gt = lists(0)
    one = sparse_decode_attention(*arrs, *_dev((bidx, gt), cuda), **kw)
    again = sparse_decode_attention(*arrs, *_dev((bidx, gt), cuda), **kw)
    other_b, other_g = lists(1)
    other_b[5], other_g[5] = bidx[5], gt[5]
    other = sparse_decode_attention(*arrs, *_dev((other_b, other_g), cuda),
                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, again)
    assert torch.equal(one[5], other[5])


def test_per_head_pipeline_matches_fused_decode(cuda):
    """lop_screen → select_blocks → sparse_decode (two launches) == the
    fused LOP decode kernel (one launch) at full width."""
    from repro_torch.serving.lop_select import select_blocks
    rng = np.random.default_rng(21)
    b, h, m, dh, block, k_keep = 4, 32, 1664, 100, 128, 2
    qi, qsc, kc, vc, ks, vs, feat = _dev(_decode(rng, b, h, h, m, dh), cuda)
    new_len = torch.tensor([1600, 1, 700, 1200], dtype=torch.int32,
                           device=cuda)
    qg = qi.reshape(b, h, 1, dh)
    ops.reset_launch_counts()
    scores = ops.lop_screen(qg, feat)
    idx, gt = select_blocks(scores, new_len, block=block, k_keep=k_keep)
    per_head = ops.sparse_decode(
        qg[..., None, :], kc, vc, qsc.reshape(b, h, 1, 1, 1), ks[..., None],
        vs[..., None], idx, gt, block=block, softmax_scale=dh ** -0.5)
    counts = ops.launch_counts()
    fused = ops.decode_attention(qi, qsc, kc, vc, ks, vs, feat, new_len,
                                 block=block, k_keep=k_keep)
    torch.cuda.synchronize()
    assert counts["lop_scores_kernel"] == counts[
        "sparse_decode_attention"] == 1
    torch.testing.assert_close(per_head.reshape(b, h, dh), fused,
                               **TOL_STANDALONE)


# ---------------------------------------------------------------------------
# the engine's decode entries as CUDA graphs, held to the eager arm
# ---------------------------------------------------------------------------

GRAPH_MAX_LEN = 63
NAN_CALLS = frozenset({(1, 0), (3, 1), (4, 2), (6, 0), (8, 1)})


def _graph_requests(sampled: bool):
    from repro_torch.serving.api import GenerateRequest, SamplingParams
    rng = np.random.default_rng(31)
    reqs = []
    for rid, n in enumerate((9, 40, 23, 51, 5)):
        sp = (SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=rid)
              if sampled else None)
        reqs.append(GenerateRequest(
            rid=rid, prompt=rng.integers(0, 512, n).astype(np.int32),
            max_new_tokens=14 - rid, **({} if sp is None
                                        else dict(sampling=sp))))
    return reqs


def _serve_arm(eng, reqs, nan=frozenset()):
    """Serve ``reqs`` on 3 slots under a fault plan. → (tokens by rid,
    every pool tensor, launch counts, scheduler)."""
    from repro_torch.serving import faults
    from repro_torch.serving.scheduler import Scheduler
    ops.reset_launch_counts()
    with faults.inject(faults.FaultPlan(nan_logits=nan)):
        sched = Scheduler(eng, n_slots=3, check_invariants=True)
        for r in reqs:
            sched.submit(r)
        res = {r.rid: r.tokens for r in sched.run_to_completion()}
    torch.cuda.synchronize()
    leaves = {}

    def snap(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                snap(v, f"{prefix}{k}.")
            else:
                leaves[f"{prefix}{k}"] = v.clone()
    snap(sched.pool)
    return res, leaves, ops.launch_counts(modes=True), sched


@pytest.mark.parametrize("use_lop,sampled,nan", [
    (True, False, frozenset()), (False, False, frozenset()),
    (True, True, frozenset()), (True, False, NAN_CALLS),
    (True, True, NAN_CALLS)],
    ids=["lop-greedy", "nolop-greedy", "lop-sampled", "lop-greedy-faults",
         "lop-sampled-faults"])
def test_graph_entries_bitwise_eager(cuda, use_lop, sampled, nan):
    from repro_torch.configs import get_config
    from repro_torch.serving.api import PooledEngine
    cfg = get_config("bitnet-3b-reduced")
    eager = PooledEngine.from_seed(cfg, seed=0, max_len=GRAPH_MAX_LEN,
                                   use_lop=use_lop, device=cuda, graphs=False)
    graph = PooledEngine(cfg, eager.qp, max_len=GRAPH_MAX_LEN,
                         use_lop=use_lop, device=cuda)
    assert eager.graphs is None and graph.graphs is not None
    reqs = _graph_requests(sampled)
    want, want_pool, want_counts, esched = _serve_arm(eager, reqs, nan)
    got, got_pool, got_counts, gsched = _serve_arm(graph, reqs, nan)
    assert got == want
    assert got_counts == want_counts
    for name, leaf in want_pool.items():
        assert torch.equal(got_pool[name], leaf), name
    if nan:
        assert gsched.fault_recoveries == esched.fault_recoveries >= 3
    held = graph.graphs.count
    assert held >= (2 if nan else 1)
    # a second pool on the same engine gets graphs of its own
    again, _, _, _ = _serve_arm(graph, reqs, nan)
    assert again == want
    assert graph.graphs.count > held and graph.graphs.nbytes > 0


def test_graph_capture_failure_raises(cuda):
    """A step that fails while captured raises; nothing runs it eagerly
    in its place, the launches counted during the failed capture are
    taken back, and the key is captured again on the next call."""
    from repro_torch.serving.graphs import StepGraphs
    pool = {"lengths": torch.zeros(2, dtype=torch.int32, device=cuda)}
    calls = []
    kernel = sorted(ops.launch_counts())[0]

    def step(pool_, inp, entry):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            ops.add_launches({kernel: 1})     # as a wrapper counts a launch
            raise RuntimeError("no capture")
        pool_["lengths"].add_(inp[0])
        return pool_["lengths"] * 1

    graphs = StepGraphs(cuda)
    host = np.ones((1, 2), np.int32)
    assert graphs.run(step, "greedy", pool, host).tolist() == [1, 1]
    counts = ops.launch_counts()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no capture"):
            graphs.run(step, "greedy", pool, host)
    assert calls == [False, True, True] and graphs.count == 0
    assert pool["lengths"].tolist() == [1, 1]
    assert ops.launch_counts() == counts


# ---------------------------------------------------------------------------
# prefix caching and speculative decoding on the card
# ---------------------------------------------------------------------------

def _reduced_engine(cuda, **kw):
    from repro_torch.configs import get_config
    from repro_torch.serving.api import PooledEngine
    return PooledEngine.from_seed(get_config("bitnet-3b-reduced"), seed=0,
                                  max_len=GRAPH_MAX_LEN, device=cuda, **kw)


def _shared_requests(n=6, seed=41):
    from repro_torch.serving.api import GenerateRequest
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 512, 32).astype(np.int32)
    return [GenerateRequest(
        rid=rid, prompt=np.concatenate(
            [shared, rng.integers(0, 512, 5 + 3 * rid).astype(np.int32)]),
        max_new_tokens=8) for rid in range(n)]


@pytest.mark.parametrize("use_lop", [True, False])
def test_prefix_hit_bitwise_miss_on_card(cuda, use_lop):
    """Hits (cloned pages, suffix chunks from the cached boundary) decode
    the cache-off run's tokens bitwise, through #3 from a non-zero start;
    every match verified its checksums clean."""
    from repro_torch.serving.scheduler import Scheduler
    eng = _reduced_engine(cuda, use_lop=use_lop)
    runs = {}
    for cached in (True, False):
        sched = Scheduler(eng, n_slots=2, prefix_cache=cached,
                          check_invariants=True)
        for r in _shared_requests():
            sched.submit(r)
        runs[cached] = ({r.rid: r.tokens for r in sched.run_to_completion()},
                        sched)
    on, off = runs[True][1], runs[False][1]
    assert runs[True][0] == runs[False][0]
    assert on.prefix_hits == 4 and off.prefix_store is None
    assert on.prefill_tokens_computed == \
        off.prefill_tokens_computed - 4 * 32
    assert on.prefix_store.checksum_failures == 0


def test_prefix_store_pages_survive_lane_eviction_on_card(cuda):
    """The store's pages are the device clones it took: evicting the lane
    they came from, prefilling another prompt into it and rolling it back
    leave them bitwise, and the next match verifies clean."""
    from repro_torch.serving import cache
    eng = _reduced_engine(cuda)
    (a,) = _shared_requests(1, seed=42)
    pool = eng.init_pool(2)
    _, one = eng.prefill(a.prompt[None])
    pool = eng.insert(pool, 1, one)
    store = cache.PrefixStore(eng.prefix_block)
    store.insert(a.prompt[:32], cache.extract_slot(pool, 1))
    _, node = store.match(a.prompt)
    snap = {k: v.clone() for k, v in store.assemble(node)["layers"].items()}
    pool = eng.evict(pool, 1)
    other_prompt = np.random.default_rng(7).integers(0, 512, 40)
    _, other = eng.prefill(other_prompt.astype(np.int32)[None])
    pool = eng.insert(pool, 1, other)
    pool = eng.rollback(pool, 1, 10)
    assert store.match(a.prompt)[0] == 32
    assert store.checksum_failures == 0
    for key, leaf in store.assemble(node)["layers"].items():
        assert torch.equal(leaf, snap[key]), key


@pytest.mark.parametrize("use_lop,sampled", [(True, False), (False, True)],
                         ids=["lop-greedy", "nolop-sampled"])
def test_spec_draft_graph_bitwise_eager(cuda, use_lop, sampled):
    """A speculative serve whose draft entries replay CUDA graphs is
    bitwise the eager engine's: tokens, every counter, launch counts; the
    verify launches #3."""
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.scheduler import Scheduler
    eager = _reduced_engine(cuda, use_lop=use_lop, graphs=False)
    graph = PooledEngine(eager.cfg, eager.qp, max_len=GRAPH_MAX_LEN,
                         use_lop=use_lop, device=cuda)
    out = []
    for eng in (eager, graph):
        ops.reset_launch_counts()
        sched = Scheduler(eng, n_slots=3, spec_decode=True, gamma=3,
                          spec_watchdog=10 ** 6, check_invariants=True)
        for r in _graph_requests(sampled):
            sched.submit(r)
        toks = {r.rid: r.tokens for r in sched.run_to_completion()}
        torch.cuda.synchronize()
        out.append((toks, ops.launch_counts(), sched.spec_rounds,
                    sched.spec_accepted, sched.draft_launches))
    assert out[0] == out[1]
    assert out[1][2] > 0 and out[1][1]["fused_prefill_attention"] > 0
    drafts = [k for k, g in graph.graphs._live.items()
              if k[0].startswith("draft") and g is not None]
    assert drafts, "no draft entry was captured"


def test_spec_pool_graphs_survive_bulk_insert_and_rollback(cuda):
    """bulk_insert, rollback and a verify chunk update the pool in place:
    the pool's graph key does not change, so the next decode and draft
    replay the graphs they captured instead of warming new keys."""
    from repro_torch.serving import cache
    from repro_torch.serving.api import ExistingPrefix
    from repro_torch.serving.graphs import graph_key
    eng = _reduced_engine(cuda)
    a, b = _shared_requests(2, seed=43)
    pool = eng.init_pool(2)
    _, one = eng.prefill(a.prompt[None])
    pool = eng.insert(pool, 0, one)
    nxt = np.zeros((2, 1), np.int32)
    params = (np.zeros(2, np.float32), np.zeros(2, np.int32),
              np.ones(2, np.float32))
    for _ in range(3):             # warm, capture, replay
        eng.decode_step(pool, nxt, *params)
        eng.draft(pool, nxt, *params)
    keys = {e: graph_key(e, pool) for e in ("greedy", "draft_greedy")}
    held, n_keys = eng.graphs.count, len(eng.graphs)
    store = cache.PrefixStore(eng.prefix_block)
    store.insert(a.prompt[:32], cache.extract_slot(pool, 0))
    node = store.match(b.prompt)[1]
    pool = eng.bulk_insert(pool, [1], ExistingPrefix(store.assemble(node),
                                                     32))
    pool = eng.rollback(pool, 0, 4)
    _, pool = eng.verify_chunk(pool, 0, np.zeros((1, 4), np.int32),
                               int(pool["lengths"][0]))
    for e, key in keys.items():
        assert graph_key(e, pool) == key, e
    eng.decode_step(pool, nxt, *params)
    eng.draft(pool, nxt, *params)
    torch.cuda.synchronize()
    assert (eng.graphs.count, len(eng.graphs)) == (held, n_keys)


# ---------------------------------------------------------------------------
# the expert axis of #1 and #2, and the MoE layer on the card
# ---------------------------------------------------------------------------

def _expert_rows(rng, e, c, k, zero_from):
    """x [E, C, k] whose rows from ``zero_from`` on are all zero in every
    expert (the empty capacity slots of a MoE dispatch)."""
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[:, zero_from:] = 0.0
    return x


@pytest.mark.parametrize("e", [1, 2, 32])
@pytest.mark.parametrize("c", [1, 8, 33, 480])
def test_expert_qlinear_kernel_matches_plain(cuda, e, c):
    """#1 with a leading expert axis: one launch, bitwise the plain
    version (a bias and an activation on one case each), zero rows giving
    exact zeros."""
    rng = np.random.default_rng(100 * e + c)
    k, n = 1024, 512
    x = _expert_rows(rng, e, c, k, zero_from=c // 2 + 1)
    packed = rng.integers(0, 256, (e, k // 4, n)).astype(np.uint8)
    gamma = rng.uniform(0.01, 0.05, (e, 1, n)).astype(np.float32)
    bias = rng.standard_normal((e, 1, n)).astype(np.float32) * 0.1
    x, packed, gamma, bias = _dev((x, packed, gamma, bias), cuda)
    for b, act in ((None, None), (bias, None), (None, "silu")):
        ops.reset_launch_counts()
        got = ops.qlinear_fused(x, packed, gamma, b, act=act)
        assert ops.launch_counts()["fused_qlinear_experts"] == 1
        want = plain.qlinear_ref(x, packed, gamma, b, act=act)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        if act is None:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **TOL)
        if b is None:
            assert not got[:, c // 2 + 1:].any()


@pytest.mark.parametrize("e", [1, 2, 32])
@pytest.mark.parametrize("c", [1, 8, 33, 480])
def test_expert_ffn_kernel_matches_plain(cuda, e, c):
    """#2 with a leading expert axis at granite-moe-1b-a400m's widths (d
    1024, f 512; γ per expert and column for gate‖up, per expert for
    down): one launch, within rtol = atol = 2e-5 of the plain version,
    zero rows giving exact zeros."""
    rng = np.random.default_rng(1000 * e + c)
    d, f = 1024, 512
    x = _expert_rows(rng, e, c, d, zero_from=c // 2 + 1)
    gu = rng.integers(0, 256, (e, d // 4, 2 * f)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (e, 1, 2 * f)).astype(np.float32)
    down = rng.integers(0, 256, (e, f // 4, d)).astype(np.uint8)
    ds = rng.uniform(0.01, 0.05, (e, 1, 1)).astype(np.float32)
    args = _dev((x, gu, gs, down, ds), cuda)
    ops.reset_launch_counts()
    got = ops.ffn_fused(*args, gated=True, act="silu")
    assert ops.launch_counts()["fused_ffn_experts"] == 1
    want = plain.ffn_fused_ref(*args[:4], args[4].expand(e, 1, d),
                               gated=True, act="silu")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    assert not got[:, c // 2 + 1:].any()


def test_expert_ffn_rows_independent_of_experts(cuda):
    """Expert e's rows of a 32-expert launch are bitwise the same rows run
    as a 1-expert launch on expert e's weights: no tile straddles two
    experts, whatever the tile (C 8 takes the 16-row decode tile)."""
    rng = np.random.default_rng(7)
    e, c, d, f = 32, 8, 1024, 512
    x = _expert_rows(rng, e, c, d, zero_from=3)
    gu = rng.integers(0, 256, (e, d // 4, 2 * f)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (e, 1, 2 * f)).astype(np.float32)
    down = rng.integers(0, 256, (e, f // 4, d)).astype(np.uint8)
    ds = rng.uniform(0.01, 0.05, (e, 1, 1)).astype(np.float32)
    args = _dev((x, gu, gs, down, ds), cuda)
    whole = ops.ffn_fused(*args, gated=True, act="silu")
    for i in (0, 13, 31):
        one = ops.ffn_fused(*(a[i:i + 1] for a in args), gated=True,
                            act="silu")
        torch.cuda.synchronize()
        assert torch.equal(one[0], whole[i]), i


def _moe_weights():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.quantize import quantize_params
    cfg = get_config("granite-moe-1b-a400m-reduced")
    qp = quantize_params(cfg, init_params(cfg, 0, "cpu"))
    return cfg, {k: v[0] for k, v in qp["layers"]["moe"].items()}


@pytest.mark.parametrize("t", [1, 4, 64, 100])
def test_moe_apply_on_card_matches_cpu(cuda, t):
    """The MoE layer on the card (routing, dispatch, #2 with E = 8, the
    combine) against the same layer on the CPU's plain path: routing
    integers bitwise, outputs within rtol = atol = 2e-5; t = 100 has a
    padded tail group and t = 64 a router biased into overflow drops."""
    from repro_torch.models import moe
    cfg, p = _moe_weights()
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((1, t, cfg.d_model)).astype(
        np.float32))
    if t == 64:
        # rows with a common positive part and a router leaning on their
        # sum: every token picks expert 0, past its capacity
        p = dict(p, router=p["router"].clone())
        p["router"][:, 0] += 0.5
        x += 1.0
    pc = {k: v.to(cuda) for k, v in p.items()}
    want = moe.moe_apply(cfg, p, x)
    got = moe.moe_apply(cfg, pc, x.to(cuda))
    grp = x[0, :min(t, cfg.moe_group)]
    r_cpu = moe.route(cfg, p["router"], grp)
    r_gpu = moe.route(cfg, pc["router"], grp.to(cuda))
    torch.cuda.synchronize()
    for a, b in zip(r_cpu[1:4], r_gpu[1:4]):
        assert torch.equal(a, b.cpu())
    if t == 64:
        assert not bool(r_cpu[3].all())           # some choices dropped
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_moe_route_rows_independent_of_the_batch(cuda):
    """A token's routing on the card (gates, experts, positions, keep)
    is bitwise the same whether it is routed alone or with 3, 7 or 479
    other tokens, at granite-moe-1b-a400m's router width (d 1024, E 32):
    what keeps a lane's tokens independent of the lanes that share its
    decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m")
    rng = np.random.default_rng(3)
    router = torch.from_numpy((rng.standard_normal(
        (cfg.d_model, cfg.n_experts)) * cfg.d_model ** -0.5).astype(
            np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((480, cfg.d_model)).astype(
        np.float32)).to(cuda)
    alone = moe.route(cfg, router, x[:1])
    for t in (4, 8, 480):
        shared = moe.route(cfg, router, x[:t])
        torch.cuda.synchronize()
        for a, b in zip(alone[:4], shared[:4]):
            assert torch.equal(a[0], b[0]), t


@pytest.mark.parametrize("use_lop,sampled,shared", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True)],
    ids=["lop-greedy", "nolop-greedy", "lop-sampled", "lop-greedy-shared"])
def test_moe_graph_entries_bitwise_eager(cuda, use_lop, sampled, shared):
    """granite-moe-1b-a400m-reduced served through the run-to-completion
    regime: the decode entries in CUDA graphs bitwise the eager engine
    (tokens, every pool tensor, launch counts), each decode step one
    grouped-expert #2 launch a layer, and the scheduler's tokens bitwise
    the port's lockstep_generate (a lane's tokens do not depend on the
    other lanes). ``shared``: ``gqa_shared_select=True``, one LOP
    candidate set a kv head (G = 2)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.scheduler import lockstep_generate
    cfg = get_config("granite-moe-1b-a400m-reduced").replace(
        gqa_shared_select=shared)
    eager = PooledEngine.from_seed(cfg, seed=0, max_len=GRAPH_MAX_LEN,
                                   use_lop=use_lop, device=cuda, graphs=False)
    graph = PooledEngine(cfg, eager.qp, max_len=GRAPH_MAX_LEN,
                         use_lop=use_lop, device=cuda)
    reqs = _graph_requests(sampled)
    want, want_pool, want_counts, esched = _serve_arm(eager, reqs)
    got, got_pool, got_counts, gsched = _serve_arm(graph, reqs)
    assert got == want
    assert got_counts == want_counts
    for name, leaf in want_pool.items():
        assert torch.equal(got_pool[name], leaf), name
    assert graph.graphs.count >= 1 and gsched.full_prefill_stalls >= 1
    # prefill: one grouped launch a layer a prompt; decode: one a step
    steps = esched.decode_launches
    assert got_counts["fused_ffn_experts"] == cfg.n_layers * (len(reqs)
                                                               + steps)
    assert got_counts["fused_ffn"] == 0
    for r in reqs:
        assert lockstep_generate(graph, r.prompt, r.max_new_tokens,
                                 sampling=r.sampling) == got[r.rid], r.rid


# ---------------------------------------------------------------------------
# the encdec family (whisper) and the dense family's LayerNorm and QKV bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c,m,kv_len", [(1, 1500, 1500, (1500,)),
                                          (1, 37, 1536, (1500,)),
                                          (3, 64, 1536, (1500, 24, 0))],
                         ids=["encoder", "cross-prefill", "cross-lanes"])
def test_prefill_noncausal_whisper_shapes(cuda, b, c, m, kv_len):
    """#3 with causal=False at whisper-small's shapes (12 heads of 64):
    the encoder's self-attention over its unpadded 1500 frames (M 1500, a
    multiple of neither the key tile nor the row tile), and the decoder's
    cross-attention over the 1536-slot cross cache at kv_len 1500 (an
    empty lane exact zero)."""
    rng = np.random.default_rng(c + m)
    arrs = _dev(_attn(rng, b, 12, 12, c, 64, m), cuda)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.prefill_attention(*arrs, lens, causal=False)
    want = plain.prefill_attention_ref(*arrs, lens, 0, causal=False,
                                       window=0, softmax_scale=64 ** -0.5)
    torch.cuda.synchronize()
    counts = ops.launch_counts(modes=True)
    assert counts["fused_prefill_attention"] == 1
    assert counts["fused_prefill_attention:non_causal"] == 1
    torch.testing.assert_close(got, want, **TOL)
    for lane, n in enumerate(kv_len):
        if n == 0:
            assert not got[lane].any()


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "dense"])
def test_decode_over_never_written_cross_cache(cuda, use_lop):
    """#4/#5 over whisper's cross cache (M 1536, 12 blocks of 128, 12
    heads of 64) with new_len = cross_len and no write: against the plain
    version, the cache bytes untouched, a second call bitwise the first,
    and the call counted under the "cross" mode."""
    from repro_torch.configs import get_config
    from repro_torch.serving.lop_select import k_keep_blocks
    cfg = get_config("whisper-small")
    m, blk = 1536, cfg.lop_block
    rng = np.random.default_rng(1536)
    arrs = _dev(_decode(rng, 4, 12, 12, m, 64), cuda)
    before = [a.clone() for a in arrs[2:]]
    cross_len = torch.tensor([1500, 24, 0, 1536], dtype=torch.int32,
                             device=cuda)
    kw = dict(block=blk, k_keep=max(1, min(k_keep_blocks(cfg, m),
                                           m // blk)), window=0,
              use_lop=use_lop)
    ops.reset_launch_counts()
    got = ops.decode_attention(*arrs, cross_len, mode="cross", **kw)
    again = ops.decode_attention(*arrs, cross_len, **kw)
    want = plain.decode_attention_ref(*arrs, cross_len,
                                      softmax_scale=64 ** -0.5, **kw)
    torch.cuda.synchronize()
    name = "fused_decode_attention" if use_lop else \
        "fused_dense_decode_attention"
    counts = ops.launch_counts(modes=True)
    assert counts[name] == 2 and counts[f"{name}:cross"] == 1
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again) and not got[2].any()
    for a, b in zip(arrs[2:], before):
        assert torch.equal(a, b)


def test_qlinear_bias_at_qwen_qkv_shape(cuda):
    """#1 with its bias epilogue at qwen1.5-32b's fused QKV (k 5120, n
    15360) at the decode rows: bitwise the plain version, counted under
    the "bias" mode."""
    rng = np.random.default_rng(5120)
    m, k, n = 4, 5120, 15360
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    gamma = rng.uniform(0.01, 0.05, (1, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) * 0.02
    x, packed, gamma, b = _dev((x, packed, gamma, b), cuda)
    ops.reset_launch_counts()
    got = ops.qlinear_fused(x, packed, gamma, b)
    want = plain.qlinear_ref(x, packed, gamma, b)
    torch.cuda.synchronize()
    assert ops.launch_counts(modes=True)["fused_qlinear:bias"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,d", [(37, 768), (1500, 768), (5, 2048)])
def test_layernorm_on_card_matches_cpu(cuda, rows, d):
    """LayerNorm on the card within 1e-6 of the CPU's, and a row bitwise
    alone and among the others on the card."""
    from repro_torch.models.layers import norm_apply
    rng = np.random.default_rng(rows + d)
    x = (rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32)
    p = {"g": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "b": (0.02 * rng.standard_normal(d)).astype(np.float32)}
    cpu = norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), "layernorm")
    pc = {k: torch.from_numpy(v).to(cuda) for k, v in p.items()}
    xc = torch.from_numpy(x).to(cuda)
    got = norm_apply(pc, xc, "layernorm")
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-6, atol=1e-6)
    for i in (0, rows - 1):
        assert torch.equal(norm_apply(pc, xc[i:i + 1], "layernorm")[0],
                           got[i])


def _encdec_requests(sampled: bool):
    from repro_torch.serving.api import GenerateRequest, SamplingParams
    rng = np.random.default_rng(9)
    reqs = []
    for rid, n in enumerate((6, 9, 4, 12, 7)):
        sp = (SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=rid)
              if sampled else None)
        prompt = rng.integers(0, 512, n).astype(np.int32)
        frames = (rng.standard_normal((4 * n, 96)).astype(np.float32) * 0.02)
        reqs.append(GenerateRequest(
            rid=rid, prompt=prompt, max_new_tokens=12 - rid, frames=frames,
            **({} if sp is None else dict(sampling=sp))))
    return reqs


@pytest.mark.parametrize("use_lop,sampled,nan", [
    (True, False, frozenset()), (False, False, frozenset()),
    (True, True, frozenset()), (True, False, NAN_CALLS)],
    ids=["lop-greedy", "nolop-greedy", "lop-sampled", "lop-greedy-faults"])
def test_encdec_graph_entries_bitwise_eager(cuda, use_lop, sampled, nan):
    """whisper-small-reduced served run-to-completion with frames: the
    decode entries in CUDA graphs bitwise the eager engine (tokens, every
    pool tensor, the cross pages and cross_len too, launch counts by mode),
    a decode step's cross-attention counted under "cross" (one a layer),
    the encoder and cross prefill under "non_causal", the FFN "ungated";
    the scheduler's tokens bitwise the port's lockstep_generate."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.scheduler import lockstep_generate
    cfg = get_config("whisper-small-reduced")
    eager = PooledEngine.from_seed(cfg, seed=0, max_len=GRAPH_MAX_LEN,
                                   use_lop=use_lop, device=cuda, graphs=False)
    graph = PooledEngine(cfg, eager.qp, max_len=GRAPH_MAX_LEN,
                         use_lop=use_lop, device=cuda)
    reqs = _encdec_requests(sampled)
    want, want_pool, want_counts, esched = _serve_arm(eager, reqs, nan)
    got, got_pool, got_counts, gsched = _serve_arm(graph, reqs, nan)
    assert got == want
    assert got_counts == want_counts
    assert "cross.k" in want_pool and "cross_len" in want_pool
    for name, leaf in want_pool.items():
        assert torch.equal(got_pool[name], leaf), name
    if nan:
        assert gsched.fault_recoveries == esched.fault_recoveries >= 3
    assert graph.graphs.count >= 1
    attn = "fused_decode_attention" if use_lop else \
        "fused_dense_decode_attention"
    steps, n = esched.decode_launches, cfg.n_layers
    if not nan:
        assert got_counts[f"{attn}:cross"] == n * steps
        assert got_counts[attn] == 2 * n * steps
    assert got_counts["fused_prefill_attention:non_causal"] == \
        (cfg.n_encoder_layers + n) * len(reqs)
    assert got_counts["fused_ffn:ungated"] == got_counts["fused_ffn"]
    for r in reqs:
        assert lockstep_generate(graph, r.prompt, r.max_new_tokens,
                                 sampling=r.sampling,
                                 frames=r.frames) == got[r.rid], r.rid


@pytest.mark.parametrize("arch", ["qwen1.5-32b-reduced",
                                  "stablelm-1.6b-reduced"])
def test_dense_features_graph_entries_bitwise_eager(cuda, arch):
    """qwen (QKV bias, drawn nonzero) and stablelm (LayerNorm) reduced:
    graphs bitwise the eager engine, every #1 QKV launch with its bias."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.quantize import quantize_params
    cfg = get_config(arch)
    params = init_params(cfg, 0, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for name in ("wq", "wk", "wv"):
        node = params["layers"]["attn"][name]
        if "b" in node:
            node["b"] = torch.randn(node["b"].shape, generator=gen,
                                    device=cuda) * 0.02
    qp = quantize_params(cfg, params)
    eager = PooledEngine(cfg, qp, max_len=GRAPH_MAX_LEN, device=cuda,
                         graphs=False)
    graph = PooledEngine(cfg, qp, max_len=GRAPH_MAX_LEN, device=cuda)
    reqs = _graph_requests(False)
    want, want_pool, want_counts, esched = _serve_arm(eager, reqs)
    got, got_pool, got_counts, _ = _serve_arm(graph, reqs)
    assert got == want and got_counts == want_counts
    for name, leaf in want_pool.items():
        assert torch.equal(got_pool[name], leaf), name
    bias = got_counts.get("fused_qlinear:bias", 0)
    assert bias == (got_counts["fused_qlinear"] // 2 if cfg.qkv_bias else 0)


# ---------------------------------------------------------------------------
# the recurrent families: rwkv6 (ssm) and jamba (hybrid)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 1536])
@pytest.mark.parametrize("k,n", [(2048, 64), (64, 2048), (2048, 7168),
                                 (7168, 2048)],
                         ids=["w_lora_a", "w_lora_b", "wk_c", "wv_c"])
def test_qlinear_at_rwkv_shapes(cuda, m, k, n):
    """#1 at rwkv6-1.6b's LoRA pair (k 2048 → n 64, k 64 → n 2048) and its
    channel mix (k 2048 → 7168, 7168 → 2048), at the decode rows and one
    1536-token prompt: bitwise the plain version."""
    rng = np.random.default_rng(k + n + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    gamma = rng.uniform(0.01, 0.05, (1, 1)).astype(np.float32)
    x, packed, gamma = _dev((x, packed, gamma), cuda)
    got = ops.qlinear_fused(x, packed, gamma)
    want = plain.qlinear_ref(x, packed, ops._col_scale(gamma, n))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _recurrent_layer_weights(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, layer_slice
    from repro_torch.serving.quantize import quantize_params
    cfg = get_config(arch)
    qp = quantize_params(cfg, init_params(cfg, 0, "cpu"))
    stack = qp["layers"] if "layers" in qp else qp["blocks"]
    return cfg, layer_slice(stack, 1)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,t", [("rwkv6-1.6b-reduced", 1),
                                    ("jamba-1.5-large-398b-reduced", 1),
                                    ("jamba-1.5-large-398b-reduced", 37)])
def test_recurrent_layer_on_card_matches_cpu(cuda, arch, t):
    """One rwkv6 layer (its ten #1 launches and the wkv recurrence) at a
    decode step and one Mamba sublayer with its MoE (``sub1``: #1, the
    f32 ``dt_proj``, the selective scan, #2 in its expert form) at a
    decode step and over a 37-token prompt, on the card from a random
    state: outputs and the written states within 2e-5 of the CPU's. (An
    rwkv6 layer over a prompt is held stage by stage:
    :func:`test_rwkv_prefill_stages_on_card_match_cpu`.)"""
    from repro_torch.serving import engine as teng
    cfg, lp = _recurrent_layer_weights(arch)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, cfg.d_model)).astype(np.float32)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import rwkv_state_shape
        shapes = rwkv_state_shape(cfg, 3)
    else:
        from repro_torch.models.mamba import mamba_state_shape
        shapes, lp = mamba_state_shape(cfg, 3), lp["sub1"]
    st = {name: (rng.standard_normal(shape) * 0.3).astype(np.float32)
          for name, (shape, _) in shapes.items()}
    outs = {}
    for dev in ("cpu", cuda):
        w = _to(lp, dev)
        # a copy each: the layer rewrites its state in place
        state = {name: torch.tensor(a, device=dev) for name, a in st.items()}
        xd = torch.from_numpy(x).to(dev)
        if cfg.family == "ssm":
            y = teng._rwkv_layer(cfg, w, xd, state)
        else:
            y = teng._mamba_layer(cfg, w, xd, state, prefill=False) \
                if t == 1 else teng._mamba_layer(cfg, w, xd, state,
                                                 prefill=True)
        outs[str(dev)] = (y.cpu(), {k: v.cpu() for k, v in state.items()})
    (y_cpu, s_cpu), (y_gpu, s_gpu) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(y_gpu, y_cpu, **TOL)
    for name in s_cpu:
        torch.testing.assert_close(s_gpu[name], s_cpu[name], **TOL)


def test_rwkv_prefill_stages_on_card_match_cpu(cuda):
    """An rwkv6 layer over a 37-token prompt, stage by stage, each stage
    on the CPU's input to it: the mixes' projections r, k, v, w, g, the
    wkv recurrence (state and y), the gated group norm in front of
    ``wo`` and the channel mix within 2e-5 of the CPU's; ``wo``'s int8
    barrier values bitwise but for 1-ulp knife-edges. (The whole layer is
    not held at 2e-5: exp, tanh and sigmoid round apart by ulps between
    the CPU and the card, and a value on a rounding boundary of the
    barrier moves its row's projection by a 127th of its scale.)"""
    from repro_torch.core.quantization import absmax_scale, quantize
    from repro_torch.models import rwkv6
    cfg, lp = _recurrent_layer_weights("rwkv6-1.6b-reduced")
    rng = np.random.default_rng(37)
    t, d, h, dh = 37, cfg.d_model, cfg.n_heads, cfg.hd
    arrs = dict(x=rng.standard_normal((3, t, d)),
                x_prev=rng.standard_normal((3, 1, d)),
                state=rng.standard_normal((3, h, dh, dh)) * 0.3)
    cpu = {k: torch.tensor(v, dtype=torch.float32) for k, v in arrs.items()}
    tm = {"cpu": lp["tm"], "gpu": _to(lp["tm"], cuda)}

    def both(fn, *args):
        """fn on the CPU's args and on the same values on the card."""
        out = [fn(tm[dev], *(a.to(cuda) if dev == "gpu" else a
                             for a in args)) for dev in ("cpu", "gpu")]
        return out[0], out[1]

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, **TOL)
    want, got = both(lambda p, x, xp: rwkv6._time_mix_inputs(cfg, p, x, xp),
                     cpu["x"], cpu["x_prev"])
    for g_, w_ in zip(got, want):
        close(g_, w_)
    r, k, v, w, g = want
    (s_c, y_c), (s_g, y_g) = both(
        lambda p, *a: rwkv6._wkv(p["u"], *a),
        *(a.transpose(0, 1) for a in (r, k, v, w)), cpu["state"])
    close(s_g, s_c)
    close(y_g, y_c)
    gated = [rwkv6._group_norm(y.transpose(0, 1), p["ln_x"], h, dh)
             .reshape(3, t, d) * gg for y, p, gg in
             ((y_c, tm["cpu"], g), (y_c.to(cuda), tm["gpu"], g.to(cuda)))]
    close(gated[1], gated[0])
    apart = quantize(gated[1]).values.cpu() != quantize(gated[0]).values
    scaled = (gated[0] / absmax_scale(gated[0]))[apart]
    assert int(apart.sum()) <= 2
    assert ((scaled.abs() % 1.0 - 0.5).abs() <= 1e-5).all(), scaled
    (out_c, _), (out_g, _) = both(
        lambda p, x, xp: rwkv6.rwkv_channel_mix(cfg, p, x, xp),
        cpu["x"], cpu["x_prev"])
    close(out_g, out_c)


RECURRENT_ARMS = [("rwkv6-1.6b-reduced", True, False, frozenset()),
                  ("rwkv6-1.6b-reduced", True, True, frozenset()),
                  ("rwkv6-1.6b-reduced", True, False, NAN_CALLS),
                  ("jamba-1.5-large-398b-reduced", True, False, frozenset()),
                  ("jamba-1.5-large-398b-reduced", False, False,
                   frozenset()),
                  ("jamba-1.5-large-398b-reduced", True, True, frozenset()),
                  ("jamba-1.5-large-398b-reduced", True, False, NAN_CALLS)]


@pytest.mark.parametrize("arch,use_lop,sampled,nan", RECURRENT_ARMS,
                         ids=["rwkv6-greedy", "rwkv6-sampled",
                              "rwkv6-greedy-faults", "jamba-lop-greedy",
                              "jamba-nolop-greedy", "jamba-lop-sampled",
                              "jamba-lop-greedy-faults"])
def test_recurrent_graph_entries_bitwise_eager(cuda, arch, use_lop, sampled,
                                               nan):
    """rwkv6 and jamba reduced, served run-to-completion: the decode
    entries (and the retry, under NaN faults) in CUDA graphs bitwise the
    eager engine — tokens, every pool tensor (the recurrent states too),
    launch counts; rwkv6 launches #1 only (ten a layer a step), jamba
    every kernel of its path; without faults the scheduler's tokens
    bitwise the port's lockstep_generate (a retry steps every lane's
    recurrent state once more, as in the reference, so under faults no
    stream has a lockstep twin)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.scheduler import lockstep_generate
    cfg = get_config(arch)
    eager = PooledEngine.from_seed(cfg, seed=0, max_len=GRAPH_MAX_LEN,
                                   use_lop=use_lop, device=cuda, graphs=False)
    graph = PooledEngine(cfg, eager.qp, max_len=GRAPH_MAX_LEN,
                         use_lop=use_lop, device=cuda)
    reqs = _graph_requests(sampled)
    want, want_pool, want_counts, esched = _serve_arm(eager, reqs, nan)
    got, got_pool, got_counts, gsched = _serve_arm(graph, reqs, nan)
    assert got == want and got_counts == want_counts
    for name, leaf in want_pool.items():
        assert torch.equal(got_pool[name], leaf), name
    assert graph.graphs.count >= 1
    if nan:
        assert gsched.fault_recoveries == esched.fault_recoveries >= 3
    steps = esched.decode_launches
    if cfg.family == "ssm":
        assert "layers.wkv" in want_pool
        assert {k for k, v in got_counts.items() if v} == {"fused_qlinear"}
        if not nan:
            assert got_counts["fused_qlinear"] == 10 * cfg.n_layers * (
                len(reqs) + steps)
    else:
        assert "blocks.mamba.ssm" in want_pool
        attn = ("fused_decode_attention" if use_lop
                else "fused_dense_decode_attention")
        for name in ("fused_qlinear", "fused_ffn", "fused_ffn_experts",
                     "fused_prefill_attention", attn):
            assert got_counts[name] > 0, name
    if nan:
        return          # a retry steps every lane's state: no lockstep twin
    for r in reqs:
        assert lockstep_generate(graph, r.prompt, r.max_new_tokens,
                                 sampling=r.sampling) == got[r.rid], r.rid


# ---------------------------------------------------------------------------
# the streamed draw and the vlm family (llava) on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [
    "bitnet-3b-reduced", "granite-moe-1b-a400m-reduced",
    "qwen1.5-32b-reduced", "whisper-small-reduced", "rwkv6-1.6b-reduced",
    "jamba-1.5-large-398b-reduced", "llava-next-34b-reduced"])
def test_streamed_draw_bitwise_on_card(cuda, arch):
    """``init_serving_params`` on the card: every served leaf bitwise
    ``quantize_params(init_params(...))`` drawn on the card (the same
    ``torch.randn`` calls in the same order from a CUDA generator)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.quantize import (init_serving_params,
                                              quantize_params)
    cfg = get_config(arch)
    want = dict(_leaves(quantize_params(cfg, init_params(cfg, 3, cuda))))
    got = dict(_leaves(init_serving_params(cfg, 3, cuda)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert leaf.is_cuda and torch.equal(got[path], leaf), path


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


VLM_MAX_LEN = 95                   # capacity 96: 16 image rows + 51 + 14


def _vlm_requests(sampled: bool, n_img: int = 16, d: int = 128):
    from repro_torch.serving.api import GenerateRequest, SamplingParams
    rng = np.random.default_rng(33)
    reqs = []
    for rid, n in enumerate((9, 40, 23, 51, 5)):
        sp = (SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=rid)
              if sampled else None)
        reqs.append(GenerateRequest(
            rid=rid, prompt=rng.integers(0, 512, n).astype(np.int32),
            max_new_tokens=14 - rid,
            patches=(rng.standard_normal((n_img, d)) * 0.02).astype(
                np.float32), **({} if sp is None else dict(sampling=sp))))
    return reqs


def test_vlm_prefill_and_decode_on_card_match_cpu(cuda):
    """Reduced llava on the CPU's weights: the embedded rows (the f32
    projector product, summed in another order on the card) within 2e-5
    of the CPU's; one request's image-prefixed first chunk and a text
    chunk past it (``prefill_chunk``), then one decode step: the int8
    pages part from the CPU's by ±1 at no more than 0.5 % of their
    entries (1-ulp knife-edges of the barrier after those rounding
    differences), the logits within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.serving import engine as teng
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.quantize import init_serving_params
    cfg = get_config("llava-next-34b-reduced")
    qp_cpu = init_serving_params(cfg, 0, "cpu")
    req = _vlm_requests(False)[3]                         # 51 text tokens
    outs = {}
    for dev in ("cpu", cuda):
        qp = _to(qp_cpu, dev)
        toks = torch.from_numpy(req.prompt.astype(np.int64)).to(dev)[None]
        patches = torch.from_numpy(req.patches).to(dev)[None]
        emb = teng._embed(cfg, qp, toks, patches)
        cache = init_cache(cfg, 1, VLM_MAX_LEN, dev)
        n_img, c = cfg.n_img_tokens, cfg.lop_block
        teng.prefill_chunk(cfg, qp, toks[:, :c], cache, start=0,
                           seq_end=n_img + c, patches=patches)
        first, _ = teng.prefill_chunk(cfg, qp, toks[:, c:], cache,
                                      start=n_img + c,
                                      seq_end=n_img + len(req.prompt))
        step, _ = teng.serve_step(cfg, qp, cache,
                                  torch.argmax(first, -1)[:, None])
        outs[str(dev)] = [t.cpu() for t in (emb, first, step)] + [
            {k: v.cpu() for k, v in cache["layers"].items()}]
    (e0, f0, s0, c0), (e1, f1, s1, c1) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(e1, e0, **TOL)
    for name in ("k", "v"):
        diff = (c1[name].to(torch.int32) - c0[name]).abs()
        assert int(diff.max()) <= 1, name
        assert float((diff > 0).float().mean()) <= 0.005, name
    torch.testing.assert_close(f1, f0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s1, s0, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("c,start", [(3008, 0), (128, 3008), (37, 3100)],
                         ids=["image-chunk", "text-chunk", "verify-rows"])
def test_vlm_prefill_kernel_at_group_7(cuda, c, start):
    """#3 at llava's shapes: 56 query heads over 8 kv heads (G 7, rows
    g-major), dh 128, a 3456-slot cache; the image-prefixed first chunk
    (2,880 + 128 rows at start 0), a text chunk past the image and a
    short block at a start that is no block multiple."""
    rng = np.random.default_rng(c + start)
    arrs = _dev(_attn(rng, 1, 56, 8, c, 128, 3456), cuda)
    kv_len = torch.tensor([start + c], dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(*arrs, kv_len, q_offset=start, causal=True)
    want = plain.prefill_attention_ref(*arrs, kv_len, start, causal=True,
                                       window=0, softmax_scale=128 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "dense"])
def test_vlm_decode_kernels_at_group_7(cuda, use_lop):
    """#4 and #5 at llava's decode shape: B 4, 56 heads over 8 (G 7), dh
    128, M 3456, llava's k_keep; lanes deep in and past the image rows,
    one retired (exact zero)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.lop_select import k_keep_blocks
    m, blk = 3456, 128
    k_keep = k_keep_blocks(get_config("llava-next-34b"), m)
    rng = np.random.default_rng(7 + use_lop)
    arrs = _dev(_decode(rng, 4, 56, 8, m, 128), cuda)
    lens = (3400, 0, 2950, 3180)
    new_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(block=blk, k_keep=k_keep, window=0, use_lop=use_lop)
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=128 ** -0.5, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()


@pytest.mark.parametrize("use_lop,sampled,nan", [
    (True, False, frozenset()), (False, False, frozenset()),
    (True, True, NAN_CALLS)],
    ids=["lop-greedy", "nolop-greedy", "lop-sampled-faults"])
def test_vlm_graph_entries_bitwise_eager(cuda, use_lop, sampled, nan):
    """Reduced llava, image requests chunked (the image on each first
    chunk): the decode entries in CUDA graphs bitwise the eager engine —
    tokens, every pool tensor, launch counts; without faults the
    scheduler's tokens bitwise the port's ``lockstep_generate(...,
    patches=)`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.scheduler import lockstep_generate
    cfg = get_config("llava-next-34b-reduced")
    eager = PooledEngine.from_seed(cfg, seed=0, max_len=VLM_MAX_LEN,
                                   use_lop=use_lop, device=cuda, graphs=False)
    graph = PooledEngine(cfg, eager.qp, max_len=VLM_MAX_LEN,
                         use_lop=use_lop, device=cuda)
    reqs = _vlm_requests(sampled)
    want, want_pool, want_counts, esched = _serve_arm(eager, reqs, nan)
    got, got_pool, got_counts, gsched = _serve_arm(graph, reqs, nan)
    assert got == want and got_counts == want_counts
    for name, leaf in want_pool.items():
        assert torch.equal(got_pool[name], leaf), name
    assert gsched.chunked and graph.graphs.count >= 1
    if nan:
        assert gsched.fault_recoveries == esched.fault_recoveries >= 1
        return
    for r in reqs:
        assert lockstep_generate(graph, r.prompt, r.max_new_tokens,
                                 sampling=r.sampling,
                                 patches=r.patches) == got[r.rid], r.rid


# ---------------------------------------------------------------------------
# the HTTP front-end on the card
# ---------------------------------------------------------------------------

def _http(port, body=None, path="/v1/completions", method="POST"):
    """One HTTP/1.1 request over loopback, the response read to its close.
    → (status, body bytes)."""
    import json
    import socket
    payload = json.dumps(body).encode() if body is not None else b""
    s = socket.create_connection(("127.0.0.1", port), timeout=300)
    s.sendall(f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Length: "
              f"{len(payload)}\r\n\r\n".encode() + payload)
    raw = b""
    while chunk := s.recv(65536):
        raw += chunk
    s.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), rest


def test_http_streams_match_direct_scheduler_on_card(cuda, monkeypatch):
    """One greedy and one seeded-sampled SSE stream through the port's
    server on the card (the pump thread capturing and replaying the decode
    graphs) equal the same requests served straight through a Scheduler
    on the same engine; /metrics counts what the run did; every token that
    reaches the event loop is a Python int (no tensor, so no CUDA call on
    the loop's thread)."""
    import json
    import threading

    from repro_torch.serving.api import GenerateRequest, SamplingParams
    from repro_torch.serving.frontend import server as server_mod
    from repro_torch.serving.metrics import MetricsRegistry
    from repro_torch.serving.scheduler import Scheduler

    eng = _reduced_engine(cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (23, 41)]
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20,
                                            top_p=0.9, seed=7)]
    direct = Scheduler(eng, n_slots=2)
    for rid, (p, sp) in enumerate(zip(prompts, sps)):
        direct.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=12,
                                      sampling=sp))
    want = {r.rid: r.tokens for r in direct.run_to_completion()}

    seen = []

    class Checked(server_mod.HttpFrontend):
        def _chunk(self, rid, sr):
            seen.append((threading.current_thread().name, type(sr.token)))
            return super()._chunk(rid, sr)

    monkeypatch.setattr(server_mod, "HttpFrontend", Checked)
    reg = MetricsRegistry()
    sched = Scheduler(eng, n_slots=2, metrics=reg)
    srv = server_mod.serve_threaded(sched, registry=reg)
    outs = {}

    def go(i):
        sp = sps[i]
        outs[i] = _http(srv.port, {
            "prompt": [int(t) for t in prompts[i]], "max_tokens": 12,
            "stream": True, "temperature": sp.temperature,
            "top_k": sp.top_k, "top_p": sp.top_p, "seed": sp.seed})

    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        status, text = _http(srv.port, path="/metrics", method="GET")
    finally:
        srv.close()
    assert srv.frontend.pump.error is None and not srv.thread.is_alive()
    assert status == 200
    for i in (0, 1):
        code, body = outs[i]
        assert code == 200
        frames = [json.loads(line[6:]) for line in body.decode().split("\n")
                  if line.startswith("data: {")]
        assert [f["choices"][0]["token"] for f in frames] == want[i], i
    assert {t for _, t in seen} == {int}
    assert {name for name, _ in seen} == {"http-frontend"}
    assert all(type(x) is int for r in sched.results for x in r.tokens)
    assert reg.value("repro_tokens_generated_total") == 24
    assert reg.value("repro_requests_total", {"outcome": "length"}) == 2
    assert (reg.value("repro_prefill_tokens_total", {"source": "computed"})
            + reg.value("repro_prefill_tokens_total", {"source": "cached"})
            == sum(len(p) for p in prompts))
    assert reg.value("repro_http_requests_total",
                     {"route": "/v1/completions", "code": 200}) == 2
    assert f"repro_decode_step_seconds_count {sched.decode_launches}" \
        in text.decode()
    assert eng.graphs.count >= 1


# ---------------------------------------------------------------------------
# the QAT training path on the card (reduced bitnet: 2 layers, vocab 256)
# ---------------------------------------------------------------------------

def _train_cfg(**kw):
    from repro_torch.configs import get_config
    return get_config("bitnet-3b-reduced").replace(n_layers=2, vocab=256,
                                                   **kw)


def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One f32 QAT step's loss and gradients on the card against the CPU's
    from the same masters: the loss within rtol 1e-5, the grad norm
    within rtol 1e-4, every gradient leaf within 1e-3 in relative norm
    (measured ≤ 5.1e-4). What parts them is pinned: every QAT BitLinear
    input is recorded, and the first whose int8 values differ (layer 1's
    Q/K/V input, one element at x/scale 36.500008 on the CPU, 36.499992
    on the card) differs only at knife-edges, x/scale within 1e-4 of one
    half-integer on both sides; later inputs carry it."""
    from repro_torch.core.quantization import quantize
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train import loss_fn
    from repro_torch.tree_util import flatten_with_path, leaves, tree_map

    cfg = _train_cfg(act_dtype="float32")
    batch = SyntheticDataset(cfg, seq_len=32, global_batch=8).batch(0)
    masters = init_params(cfg, 0)
    real = layers.bitlinear_qat
    out, rec = {}, {}
    for dev in ("cpu", str(cuda)):
        xs = rec[dev] = []

        def recorded(x, w, *a, xs=xs, **k):
            xs.append(x.detach().to("cpu", copy=True))
            return real(x, w, *a, **k)
        monkeypatch.setattr(layers, "bitlinear_qat", recorded)
        params = tree_map(lambda t: t.to(dev, copy=True), masters)
        for p in leaves(params):
            p.requires_grad_(True)
        loss, _ = loss_fn(cfg, params, {k: torch.from_numpy(v).to(dev)
                                        for k, v in batch.items()})
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in flatten_with_path(params)}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        out[dev] = (float(loss.detach()), float(norm), grads)
    (l0, n0, g0), (l1, n1, g1) = out["cpu"], out[str(cuda)]
    assert abs(l1 - l0) <= 1e-5 * abs(l0) and abs(n1 - n0) <= 1e-4 * n0
    for k, g in g0.items():
        assert float((g1[k] - g).norm() / g.norm()) < 1e-3, k
    for a, b in zip(rec["cpu"], rec[str(cuda)]):
        qa, qb = quantize(a), quantize(b)
        apart = [tuple(j) for j in (qa.values != qb.values).nonzero().tolist()]
        if apart:
            for j in apart:
                for x, q in ((a, qa), (b, qb)):
                    r = float(x[j] / q.scale[j[:-1]])
                    assert abs(r - np.floor(r) - 0.5) < 1e-4, (j, r)
            break


def test_train_resume_on_card_bitwise(cuda, tmp_path):
    """12 steps straight on the card == preempted after 6 (checkpointed)
    + a restart for the rest: the losses bitwise."""
    from repro_torch.launch.train import train_loop

    class StopAfter:
        def __init__(self):
            self.polls = 0

        @property
        def preempted(self):
            self.polls += 1
            return self.polls >= 6

    cfg = _train_cfg()
    kw = dict(steps=12, global_batch=8, seq_len=32, peak_lr=3e-3,
              log_every=1000, device=cuda)
    straight = train_loop(cfg, **kw)
    cut = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=100,
                     preemption=StopAfter(), **kw)
    rest = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=100, **kw)
    assert cut["last_step"] == 6 and len(rest["losses"]) == 6
    assert cut["losses"] + rest["losses"] == straight["losses"]


def test_train_kernels_on_trained_weights(cuda):
    """20 QAT steps on the card, the masters quantized: #1 at layer 0's
    QKV and #2 at its FFN, on the trained served weights, bitwise their
    plain versions (m 4 and 33)."""
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.quantize import quantize_params

    cfg = _train_cfg()
    out = train_loop(cfg, steps=20, global_batch=8, seq_len=32,
                     peak_lr=3e-3, log_every=1000, device=cuda)
    lp = layer_slice(quantize_params(cfg, out["params"])["layers"], 0)
    qkv, ffn = lp["attn"]["wqkv"], lp["ffn"]
    rng = np.random.default_rng(29)
    for m in (4, 33):
        x = torch.from_numpy(rng.standard_normal((m, cfg.d_model)).astype(
            np.float32)).to(cuda)
        got = ops.qlinear_fused(x, qkv["packed"], qkv["scale"])
        want = plain.qlinear_ref(x, qkv["packed"], ops._col_scale(
            qkv["scale"], qkv["packed"].shape[-1]))
        assert torch.equal(got, want)
        args = (x, ffn["gu_packed"], ffn["gu_scale"], ffn["down_packed"],
                ffn["down_scale"])
        got = ops.ffn_fused(*args, gated=True, act="silu")
        want = plain.ffn_fused_ref(
            x, ffn["gu_packed"], ops._col_scale(
                ffn["gu_scale"], ffn["gu_packed"].shape[-1]),
            ffn["down_packed"], ops._col_scale(ffn["down_scale"],
                                               cfg.d_model),
            gated=True, act="silu")
        torch.cuda.synchronize()
        assert torch.equal(got, want), m


# ---------------------------------------------------------------------------
# the recurrent families' training and the int8 gradient compression on the
# card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_train_recurrent_on_card_matches_cpu(cuda, arch):
    """Reduced rwkv6 / jamba at f32 from the same masters (drawn on the
    CPU), step 1 without remat: on its own forward the card's first int8
    parting from the CPU is a knife-edge (x/scale within 1e-4 of a
    half-integer on both sides: the two devices' f32 rounding, which a
    flip carries on); with every QAT BitLinear input replaced by the
    CPU's in value (the partings knife-edges) the loss is within 1e-4 and
    the pre-clip grad norm within 1e-4 of itself; then 30 steps on the
    card (bf16, batch 8 x 32, lr 3e-3) whose last-5 mean loss is below
    the first-5 mean (``chip_smoke.py`` phase 4l (b))."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import init_params
    from torch_knife_edges import knife_edges, step1_grads

    cfg = get_config(f"{arch}-reduced")
    f32 = cfg.replace(act_dtype="float32")
    masters = init_params(f32, 0)
    batch = SyntheticDataset(f32, seq_len=32, global_batch=8).batch(0)
    l0, n0, xs = step1_grads(f32, masters, batch, "cpu")
    _, _, own = step1_grads(f32, masters, batch, str(cuda))
    knife_edges(own, xs, 1e-4, first_only=True)
    l1, n1, sub = step1_grads(f32, masters, batch, str(cuda),
                              replay=xs)
    knife_edges(sub, xs, 1e-4)
    assert abs(l1 - l0) <= 1e-4 and abs(n1 / n0 - 1) <= 1e-4, (l0, l1,
                                                               n0, n1)
    losses = train_loop(cfg, device=cuda, steps=30, global_batch=8,
                        seq_len=32, peak_lr=3e-3, log_every=1000)["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_train_compressed_psum_on_card_bitwise_cpu(cuda):
    """``compressed_psum`` on a single-process mesh of 8 shards of 64 on
    CUDA tensors: one shot and 16 rounds of error feedback, sums and
    error states bitwise the CPU's; ``compressed_psum_tree`` likewise."""
    from repro_torch.distributed.compression import (compressed_psum,
                                                     compressed_psum_tree,
                                                     init_error_state)
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.tree_util import leaves

    mesh = local_mesh((8,), ("data",))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    errs = {"cpu": torch.zeros(8, 64), "cuda": torch.zeros(8, 64,
                                                            device=cuda)}
    for _ in range(17):
        tot_c, errs["cpu"] = compressed_psum(x, "data", errs["cpu"], mesh)
        tot_g, errs["cuda"] = compressed_psum(x.to(cuda), "data",
                                              errs["cuda"], mesh)
        assert torch.equal(tot_g.cpu(), tot_c)
        assert torch.equal(errs["cuda"].cpu(), errs["cpu"])
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 5, 7)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (8, 3)).astype(np.float32))}
    gtree = {k: v.to(cuda) for k, v in tree.items()}
    got, gerr = compressed_psum_tree(gtree, "data", init_error_state(gtree),
                                     mesh)
    want, err = compressed_psum_tree(tree, "data", init_error_state(tree),
                                     mesh)
    for a, b in zip(leaves(got) + leaves(gerr), leaves(want) + leaves(err)):
        assert torch.equal(a.cpu(), b)


def _gloo_compress_rank(mesh, x):
    """A rank of :func:`test_train_compressed_mean_over_gloo_on_card`: its
    row of ``x`` on cuda:0 through ``compressed_psum`` 4 rounds."""
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.partitioning import Mesh

    data = Mesh(("data",), {"data": mesh.size("model")}, mesh.group)
    r = data.rank("data")
    mine = x[r:r + 1].cuda()
    err, out = torch.zeros_like(mine), []
    for _ in range(4):
        total, err = compressed_psum(mine, "data", err, data)
        out.append((total.cpu(), err.cpu()))
    return out


def test_train_compressed_mean_over_gloo_on_card(cuda):
    """2 gloo ranks on cuda:0, a row of x each, 4 rounds: each round's sum
    bitwise on both ranks and the single-process mesh's on the card, each
    rank's error state its row of the single-process mesh's (the int32
    codes reduced by gloo on CUDA tensors)."""
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import local_mesh, spawn_ranks

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 300)).astype(np.float32))
    ranks = spawn_ranks("test_torch_gpu:_gloo_compress_rank", 2, (x,),
                        timeout=300)
    mesh = local_mesh((2,), ("data",))
    xs = x.to(cuda)
    err = torch.zeros_like(xs)
    for i in range(4):
        total, err = compressed_psum(xs, "data", err, mesh)
        for r in range(2):
            assert torch.equal(ranks[r][i][0], total.cpu())
            assert torch.equal(ranks[r][i][1], err[r:r + 1].cpu())



# ---- the tile autotuner's knobs (kernels/autotune.py) ----

def _tune_cases():
    """Each swept kernel at the main path's full-width shapes
    (``autotune.DEFAULT_SHAPES``: bitnet-3b's) and at a dh-32 reduced
    shape (bitnet-3b-reduced's widths)."""
    from repro_torch.kernels import autotune
    reduced = {
        "ternary_matmul": {"m": 8, "k": 128, "n": 384},
        "qlinear": {"e": 1, "m": 2, "k": 128, "n": 384},
        "ffn": {"e": 1, "m": 32, "k": 128, "f": 256, "n": 128},
        "decode": {"bhg": 8, "g": 1, "d": 32, "m": 64, "block": 32,
                   "k_keep": 1}}
    return [(k, d) for k in reduced
            for d in (*autotune.DEFAULT_SHAPES[k], reduced[k])]


@pytest.mark.parametrize("kernel,dims", _tune_cases(),
                         ids=lambda v: v if isinstance(v, str) else
                         ",".join(f"{a}={b}" for a, b in v.items()))
def test_every_tune_candidate_bitwise_default(cuda, kernel, dims):
    """Every legal candidate of the sweep (not only the first few), on the
    sweep's own operands, is bitwise the default launch (every knob 0);
    the default is the plain version's result where the output is exact
    (the integer GEMM), within the serving tolerance elsewhere."""
    from repro_torch.kernels import autotune
    args, runner = autotune._make_runner(kernel, dims)
    cands = autotune.candidates(kernel, dims, max_candidates=10_000)
    assert len(cands) > 1 and cands[0] == dict.fromkeys(cands[0], 0)

    def outputs(p):
        got = runner(p)(*args)
        torch.cuda.synchronize()
        return got if isinstance(got, tuple) else (got,)

    want = outputs(cands[0])
    for p in cands[1:]:
        for a, b in zip(outputs(p), want):
            assert torch.equal(a, b), p
    if kernel == "ternary_matmul":
        x, w = args
        assert torch.equal(want[0], plain.ternary_matmul_ref(x, w, x.shape[1]))


@pytest.mark.parametrize("kernel,knobs", [
    ("qlinear", {"split": 2, "tile": 128}),
    ("qlinear", {"split": 1, "tile": 16}),
    ("ffn", {"split_gu": 3, "split_down": 5, "tile": 128}),
    ("ternary_matmul", {"split": 4, "tile": 128}),
    ("decode", {"stages": 4}),
    ("decode", {"stages": 3})])
def test_override_reaches_the_launch(cuda, kernel, knobs, monkeypatch):
    """An ``override`` reaches the C entry through ``ops``: the knobs the
    wrapper receives are the override's, the launch plan at those knobs
    (``launch_shape``, the plan the entry launches) is what they ask for
    and differs from the default plan, and the result is bitwise the
    default's."""
    import importlib

    from repro_torch.kernels import autotune
    # the package re-exports ops' entries under these modules' names
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    ql = importlib.import_module("repro_torch.kernels.qlinear")
    tmm = importlib.import_module("repro_torch.kernels.ternary_matmul")

    rng = np.random.default_rng(11)
    seen = {}

    def spy(name):
        real = getattr(ops, name)

        def call(*a, **kw):
            seen.update({k: kw[k] for k in knobs if k in kw})
            return real(*a, **kw)
        call.launches, call.modes = real.launches, real.modes
        monkeypatch.setattr(ops, name, call)

    if kernel in ("qlinear", "ffn", "ternary_matmul"):
        m, k, n, f = 4, 3200, 3200, 8640
        if kernel == "qlinear":
            spy("fused_qlinear")
            x, w, g = _dev((rng.standard_normal((m, k)).astype(np.float32),
                            rng.integers(0, 256, (k // 4, n), np.uint8),
                            rng.uniform(0.01, 0.05, (1, n)).astype(
                                np.float32)), cuda)
            call = lambda: ops.qlinear_fused(x, w, g)  # noqa: E731
            plan = lambda **kn: ql.launch_shape(m, k, n, **kn)  # noqa: E731
        elif kernel == "ffn":
            spy("fused_ffn")
            x, gu, gs, dn, ds = _dev((
                rng.standard_normal((m, k)).astype(np.float32),
                rng.integers(0, 256, (k // 4, 2 * f), np.uint8),
                rng.uniform(0.01, 0.05, (1, 2 * f)).astype(np.float32),
                rng.integers(0, 256, (f // 4, n), np.uint8),
                rng.uniform(0.01, 0.05, (1, 1)).astype(np.float32)), cuda)
            call = lambda: ops.ffn_fused(  # noqa: E731
                x, gu, gs, dn, ds, gated=True, act="silu")

            def plan(split_gu=0, split_down=0, tile=0):
                return ql.launch_shape(m, k, f, gated=True, split=split_gu,
                                       tile=tile)
        else:
            from repro_torch.core.ternary import TernaryWeight
            spy("ternary_matmul_kernel")
            m = 128
            x, w = _dev((rng.integers(-127, 128, (m, k), np.int8),
                         rng.integers(0, 256, (k // 4, n), np.uint8)), cuda)
            tw = TernaryWeight(packed=w, scale=None, shape=(k, n))
            call = lambda: ops.ternary_matmul(x, tw)  # noqa: E731
            plan = lambda **kn: tmm.launch_shape(m, k, n, **kn)  # noqa: E731
    else:
        spy("fused_decode_attention")
        b, h, m, dh, blk = 4, 32, 1664, 100, 128
        qi, qsc, kc, vc, ks, vs, feat = _dev((
            rng.integers(-127, 128, (b, h, dh), np.int8),
            rng.uniform(0.01, 0.02, (b, h, 1)).astype(np.float32),
            rng.integers(-127, 128, (b, h, m, dh), np.int8),
            rng.integers(-127, 128, (b, h, m, dh), np.int8),
            rng.uniform(0.01, 0.02, (b, h, m)).astype(np.float32),
            rng.uniform(0.01, 0.02, (b, h, m)).astype(np.float32),
            rng.integers(0, 256, (b, h, m, dh // 2), np.uint8)), cuda)
        nl = torch.tensor([1600, 0, 700, 1200], dtype=torch.int32,
                          device=cuda)
        call = lambda: ops.decode_attention(  # noqa: E731
            qi, qsc, kc, vc, ks, vs, feat, nl, block=blk, k_keep=2)
        plan = lambda **kn: dec.launch_shape(  # noqa: E731
            b * h, 1, m, dh, blk, k_keep=2, **kn)
    want = call()
    default = plan()
    with autotune.override(kernel, **knobs):
        got = call()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert seen == knobs
    shape = plan(**knobs)
    for name, value in knobs.items():
        key = {"split_gu": "split", "split_down": None}.get(name, name)
        if key is not None:
            assert shape[key] == value, (name, shape)
    assert shape != default
    print(f"{kernel} {knobs}: default {default}, tuned {shape}")


def test_no_table_launch_shape_is_the_plan(cuda, monkeypatch, tmp_path):
    """With no table and no override, ``lookup`` names no knob at every
    main-path shape, so every launch is the kernels' own plan: the tile
    by m (16 rows to m 16, 128 above) and the decode kernels' two-stage
    ring, and the launch at knobs 0 is the launch at the plan's own split
    and tile, named explicitly."""
    import importlib

    from repro_torch.kernels import autotune
    # the package re-exports ops' entries under these modules' names
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    ql = importlib.import_module("repro_torch.kernels.qlinear")
    tmm = importlib.import_module("repro_torch.kernels.ternary_matmul")
    monkeypatch.setenv(autotune.TABLE_ENV, str(tmp_path / "absent.json"))
    monkeypatch.delenv(autotune.TUNE_ENV, raising=False)
    for kernel, shapes in autotune.DEFAULT_SHAPES.items():
        for d in shapes:
            assert autotune.lookup(kernel, d) == {}, (kernel, d)
            if kernel == "decode":
                for lop in (True, False):
                    s = dec.launch_shape(d["bhg"], d["g"], d["m"], d["d"],
                                         d["block"], k_keep=d["k_keep"],
                                         lop=lop)
                    assert s["stages"] == 2
                    assert s == dec.launch_shape(
                        d["bhg"], d["g"], d["m"], d["d"], d["block"],
                        k_keep=d["k_keep"], lop=lop, stages=2)
                    assert s["smem"] == autotune.decode_smem(d, 2, lop=lop)
                    print(f"decode {d} lop={lop}: {s}")
                continue
            tile = 16 if d["m"] <= 16 else 128
            if kernel == "ffn":
                plans = [(lambda **kn: ql.launch_shape(
                    d["m"], d["k"], d["f"], gated=True, **kn)),
                    (lambda **kn: ql.launch_shape(d["m"], d["f"], d["n"],
                                                  **kn))]
            elif kernel == "qlinear":
                plans = [lambda **kn: ql.launch_shape(d["m"], d["k"], d["n"],
                                                      **kn)]
            else:
                plans = [lambda **kn: tmm.launch_shape(d["m"], d["k"],
                                                       d["n"], **kn)]
            for plan in plans:
                s = plan()
                assert s["tile"] == tile
                assert s == plan(split=s["split"], tile=tile)
                print(f"{kernel} {d}: {s}")


# ---------------------------------------------------------------------------
# the dry-run's predictions against the card (launch/dryrun.py,
# analysis/op_trace.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "dense"])
def test_dryrun_decode_step_predicts_the_card(cuda, use_lop):
    """One decode step of reduced bitnet-3b traced on meta: its launches
    by kernel equal the card's counts, its argument bytes the nbytes of
    the served tree, the pool and the tokens on the card."""
    from repro_torch.analysis.op_trace import OpTrace
    from repro_torch.configs import get_config
    from repro_torch.serving.cache import init_cache_pool
    from repro_torch.serving.engine import serve_step
    from repro_torch.serving.quantize import init_serving_params
    from repro_torch.tree_util import leaves

    cfg = get_config("bitnet-3b-reduced")
    b, max_len = 4, 63
    qp_m = init_serving_params(cfg, 0, "meta")
    pool_m = init_cache_pool(cfg, b, max_len, "meta")
    tok_m = torch.empty((b, 1), dtype=torch.int64, device="meta")
    tr = OpTrace()
    tr.arguments(qp_m, pool_m, tok_m)
    with tr:
        serve_step(cfg, qp_m, pool_m, tok_m, use_lop=use_lop)
    qp = init_serving_params(cfg, 0, cuda)
    pool = init_cache_pool(cfg, b, max_len, cuda)
    pool["active"].fill_(True)
    pool["lengths"].copy_(torch.tensor([40, 1, 17, 62], dtype=torch.int32))
    tokens = torch.tensor([[3], [5], [7], [11]], device=cuda)
    ops.reset_launch_counts()
    logits, _ = serve_step(cfg, qp, pool, tokens, use_lop=use_lop)
    torch.cuda.synchronize()
    counted = {k: v for k, v in ops.launch_counts(modes=True).items() if v}
    assert tr.kernels == counted
    assert torch.isfinite(logits).all()
    card = sum(x.numel() * x.element_size() for t in (qp, pool, tokens)
               for x in leaves(t))
    assert tr.argument_bytes() == card


# ---------------------------------------------------------------------------
# the last full-width configurations: mixtral-8x22b's expert FFN and its
# sliding window past the window's end, jamba's sublayer-streamed draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [4, 640])
def test_expert_ffn_at_mixtral_width_bitwise(cuda, c):
    """#2 with the expert axis at mixtral-8x22b's widths (E 8, d 6144, f
    16,384) at the decode capacity (C 4) and a full 2048-token group's
    (C 640): one launch, bitwise the plain version, zero rows exact
    zeros."""
    rng = np.random.default_rng(c)
    e, d, f = 8, 6144, 16384
    x = _expert_rows(rng, e, c, d, zero_from=c // 2 + 1)
    gu = rng.integers(0, 256, (e, d // 4, 2 * f)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (e, 1, 2 * f)).astype(np.float32)
    down = rng.integers(0, 256, (e, f // 4, d)).astype(np.uint8)
    ds = rng.uniform(0.01, 0.05, (e, 1, 1)).astype(np.float32)
    args = _dev((x, gu, gs, down, ds), cuda)
    ops.reset_launch_counts()
    got = ops.ffn_fused(*args, gated=True, act="silu")
    assert ops.launch_counts()["fused_ffn_experts"] == 1
    want = plain.ffn_fused_ref(*args[:4], args[4].expand(e, 1, d),
                               gated=True, act="silu")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert not got[:, c // 2 + 1:].any()


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "dense"])
def test_decode_kernels_past_the_window_at_group_6(cuda, use_lop):
    """#4 and #5 at mixtral-8x22b's decode shape: B 4, 48 heads over 8 (G
    6), dh 128, M 4736 (capacity of a 4700-token prompt and 32 new),
    swa_window 4096, lanes past the window's end (4700, 4200), inside it
    (1500) and retired (exact zero)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.lop_select import k_keep_blocks
    cfg = get_config("mixtral-8x22b")
    m, blk = 4736, cfg.lop_block
    k_keep = k_keep_blocks(cfg, m)
    rng = np.random.default_rng(11 + use_lop)
    arrs = _dev(_decode(rng, 4, 48, 8, m, 128), cuda)
    new_len = torch.tensor((4700, 0, 1500, 4200), dtype=torch.int32,
                           device=cuda)
    kw = dict(block=blk, k_keep=k_keep, window=cfg.swa_window,
              use_lop=use_lop)
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=128 ** -0.5, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()


def test_hybrid_sublayer_draw_bitwise_on_card(cuda):
    """Reduced jamba drawn on the card a sublayer at a time: each entry
    ``draw_params`` yields is one sublayer, bitwise its slice of the
    whole-tree ``init_params`` drawn on the card, and the streamed served
    tree bitwise ``quantize_params`` of the whole tree."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import draw_params, init_params
    from repro_torch.serving.quantize import (init_serving_params,
                                              quantize_params)
    cfg = get_config("jamba-1.5-large-398b-reduced")
    whole = init_params(cfg, 3, cuda)
    n = 0
    for name, i, _, tree in draw_params(cfg, 3, cuda):
        if i is None:
            continue
        (sub,) = tree
        n += 1
        want = dict(_leaves(whole[name][sub]))
        for path, leaf in _leaves(tree[sub]):
            assert torch.equal(leaf, want[path][i]), (i, sub, path)
    assert n == cfg.n_layers
    want = dict(_leaves(quantize_params(cfg, whole)))
    got = dict(_leaves(init_serving_params(cfg, 3, cuda)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert torch.equal(got[path], leaf), path


# ---------------------------------------------------------------------------
# qwen1.5-110b's shapes: #4/#5 at G 8, #2 at f 49,152, #1 + bias at its
# fused QKV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "dense"])
def test_decode_kernels_at_group_8(cuda, use_lop):
    """#4 and #5 at qwen1.5-110b's decode shape: B 4, 64 heads of 128
    over 8 (G 8), M 1664, lanes of 1600, 0 (retired: exact zero), 700 and
    1200 tokens; against the plain version, and every ring depth the tile
    sweep may pick bitwise the default launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        fused_decode_attention, fused_dense_decode_attention)
    from repro_torch.serving.lop_select import k_keep_blocks
    cfg = get_config("qwen1.5-110b")
    b, h, hkv, m, dh = 4, cfg.n_heads, cfg.n_kv_heads, 1664, cfg.hd
    blk, k_keep = cfg.lop_block, k_keep_blocks(cfg, 1664)
    rng = np.random.default_rng(110 + use_lop)
    arrs = _dev(_decode(rng, b, h, hkv, m, dh), cuda)
    new_len = torch.tensor((1600, 0, 700, 1200), dtype=torch.int32,
                           device=cuda)
    kw = dict(block=blk, k_keep=k_keep, window=0, use_lop=use_lop)
    ops.reset_launch_counts()
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=dh ** -0.5, **kw)
    torch.cuda.synchronize()
    name = "fused_decode_attention" if use_lop else \
        "fused_dense_decode_attention"
    assert ops.launch_counts()[name] == 1
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()
    g = h // hkv
    lanes = [arrs[0].reshape(b * hkv, g, dh), arrs[1].reshape(b * hkv, g),
             *(a.reshape(b * hkv, *a.shape[2:]) for a in arrs[2:6])]
    if use_lop:
        lanes.append(arrs[6].reshape(b * hkv, m, dh // 2))
    call = fused_decode_attention if use_lop else fused_dense_decode_attention
    extra = dict(k_keep=k_keep) if use_lop else {}
    base = call(*lanes, new_len, hkv=hkv, block=blk, window=0,
                softmax_scale=dh ** -0.5, **extra)
    assert torch.equal(base.reshape(got.shape), got)
    for stages in (2, 3, 4):
        again = call(*lanes, new_len, hkv=hkv, block=blk, window=0,
                     softmax_scale=dh ** -0.5, stages=stages, **extra)
        assert torch.equal(again, base), stages


def test_ffn_at_qwen110b_width_bitwise(cuda):
    """#2 at qwen1.5-110b's widths (d 8192, f 49,152) at the decode rows
    (m 4): bitwise the plain version (a float64 unpack of 9.7 GB)."""
    rng = np.random.default_rng(49152)
    args = _dev(_ffn_args(rng, 4, 8192, 49152, True), cuda)
    got = ops.ffn_fused(*args, gated=True, act="silu")
    want = _ffn_plain(args, 8192, True, "silu")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_qlinear_bias_at_qwen110b_qkv_shape(cuda):
    """#1 with its bias epilogue at qwen1.5-110b's fused QKV (k 8192, n
    8192 + 2 · 1024) at the decode rows: bitwise the plain version,
    counted under the "bias" mode."""
    rng = np.random.default_rng(8192)
    m, k, n = 4, 8192, 10240
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    gamma = rng.uniform(0.01, 0.05, (1, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) * 0.02
    x, packed, gamma, b = _dev((x, packed, gamma, b), cuda)
    ops.reset_launch_counts()
    got = ops.qlinear_fused(x, packed, gamma, b)
    want = plain.qlinear_ref(x, packed, gamma, b)
    torch.cuda.synchronize()
    assert ops.launch_counts(modes=True)["fused_qlinear:bias"] == 1
    assert torch.equal(got, want)
