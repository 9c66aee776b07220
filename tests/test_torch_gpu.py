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
    (7, 100, 64, False, None)])
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
    if act is None:
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
    (1326, 256, 512, True, "silu")])
def test_ffn_kernel_matches_plain(cuda, m, d, f, gated, act):
    rng = np.random.default_rng(m + f)
    args = _dev(_ffn_args(rng, m, d, f, gated), cuda)
    got = ops.ffn_fused(*args, gated=gated, act=act)
    want = _ffn_plain(args, d, gated, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


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
    (2, 4, 2, 13, 64, 96, 0, True), (3, 8, 2, 20, 128, 128, 0, False)])
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
    (4, 8, 8, 1664, 100, 128, 2, 200, (300, 600, 1100, 1664))])
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


@pytest.mark.parametrize("mode", [dict(shared_select=True),
                                  dict(return_stats=True),
                                  dict(pos_offset=128)])
def test_decode_kernel_rejects_unported_modes(cuda, mode):
    rng = np.random.default_rng(0)
    arrs = _dev(_decode(rng, 1, 4, 4, 256, 32), cuda)
    new_len = torch.tensor([200], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.decode_attention(*arrs, new_len, block=128, k_keep=1, **mode)


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
    pool = sched.pool
    leaves = {k: v.clone() for k, v in pool.items() if k != "layers"}
    leaves.update({f"layers.{k}": v.clone()
                   for k, v in pool["layers"].items()})
    return res, leaves, ops.launch_counts(), sched


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
