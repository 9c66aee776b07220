"""Each CUDA kernel of the port held against its plain PyTorch version on
the card. Marked ``gpu``; without a CUDA card every test skips (decided in
the ``cuda`` fixture, never at import). Run on a card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: outputs whose float steps the kernel repeats op for op (the
projection without an activation) must be bitwise; everything else agrees
to rtol = atol = 2e-5 (online vs. one-pass softmax, other exp/tanh code).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as plain

pytestmark = pytest.mark.gpu

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
    (33, 96, 40, True, "silu"), (9, 128, 64, False, "gelu")])
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


@pytest.mark.parametrize("m", [4, 128])
def test_ffn_kernel_matches_plain(cuda, m):
    rng = np.random.default_rng(m)
    d, f = 3200, 8640
    x = rng.standard_normal((m, d)).astype(np.float32)
    gu = rng.integers(0, 256, (d // 4, 2 * f)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (1, 2 * f)).astype(np.float32)
    down = rng.integers(0, 256, (f // 4, d)).astype(np.uint8)
    ds = np.full((1, 1), 0.02, np.float32)
    args = _dev((x, gu, gs, down, ds), cuda)
    got = ops.ffn_fused(*args, gated=True, act="silu")
    want = plain.ffn_fused_ref(args[0], args[1], args[2], args[3],
                               args[4].expand(1, d), gated=True, act="silu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


def _attn(rng, b, h, hkv, c, dh, m):
    return (rng.integers(-127, 128, (b, h, c, dh)).astype(np.int8),
            (rng.random((b, h, c)) * 0.1 + 0.01).astype(np.float32),
            rng.integers(-127, 128, (b, hkv, m, dh)).astype(np.int8),
            rng.integers(-127, 128, (b, hkv, m, dh)).astype(np.int8),
            (rng.random((b, hkv, m)) * 0.1 + 0.01).astype(np.float32),
            (rng.random((b, hkv, m)) * 0.1 + 0.01).astype(np.float32))


@pytest.mark.parametrize("b,h,hkv,c,dh,m,window,causal", [
    (1, 32, 32, 128, 100, 1664, 0, True), (2, 4, 2, 8, 32, 64, 12, True),
    (2, 4, 2, 8, 100, 64, 0, False)])
def test_prefill_kernel_matches_plain(cuda, b, h, hkv, c, dh, m, window,
                                      causal):
    rng = np.random.default_rng(dh + m)
    arrs = _dev(_attn(rng, b, h, hkv, c, dh, m), cuda)
    kvl = m - 100 if m > 200 else m - 24
    kv_len = torch.tensor([kvl, 0][:b], dtype=torch.int32, device=cuda)
    kw = dict(q_offset=kvl - c, causal=causal, window=window)
    got = ops.prefill_attention(*arrs, kv_len, **kw)
    want = plain.prefill_attention_ref(*arrs, kv_len, kvl - c,
                                       causal=causal, window=window,
                                       softmax_scale=dh ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    if b > 1:
        assert not got[1].any()


def test_prefill_chunked_bitwise_whole_on_card(cuda):
    rng = np.random.default_rng(11)
    s, c, m = 300, 128, 1664
    qi, qsc, ki, vi, ks, vs = _dev(_attn(rng, 1, 32, 32, 384, 100, m), cuda)
    whole = ops.prefill_attention(qi[:, :, :s], qsc[:, :, :s], ki, vi, ks, vs,
                                  torch.tensor([s], dtype=torch.int32,
                                               device=cuda))
    for start in range(0, s, c):
        part = ops.prefill_attention(
            qi[:, :, start:start + c], qsc[:, :, start:start + c], ki, vi, ks,
            vs, torch.tensor([start + c], dtype=torch.int32, device=cuda),
            q_offset=start)
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


@pytest.mark.parametrize("b,h,hkv,m,dh,block,k_keep,window", [
    (4, 32, 32, 1664, 100, 128, 2, 0), (4, 32, 32, 1664, 100, 128, 2, 300),
    (3, 8, 2, 128, 32, 16, 3, 0)])
def test_decode_kernel_matches_plain(cuda, b, h, hkv, m, dh, block, k_keep,
                                     window):
    rng = np.random.default_rng(m + dh)
    arrs = _dev(_decode(rng, b, h, hkv, m, dh), cuda)
    new_len = torch.tensor([m - 64, 0, m // 3, block + 1][:b],
                           dtype=torch.int32, device=cuda)
    kw = dict(block=block, k_keep=k_keep, window=window)
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=dh ** -0.5, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()                          # retired lane → zero


@pytest.mark.parametrize("dh", [32, 100])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [0, 256])
def test_dense_decode_kernel_matches_plain(cuda, dh, g, window):
    rng = np.random.default_rng(dh * 10 + g + window)
    b, hkv, m, block = 4, 8, 1664, 128
    arrs = _dev(_decode(rng, b, g * hkv, hkv, m, dh), cuda)
    new_len = torch.tensor([m - 64, 0, 700, block + 1], dtype=torch.int32,
                           device=cuda)
    kw = dict(block=block, k_keep=2, window=window, use_lop=False)
    ops.reset_launch_counts()
    got = ops.decode_attention(*arrs, new_len, **kw)
    want = plain.decode_attention_ref(*arrs, new_len,
                                      softmax_scale=dh ** -0.5, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_dense_decode_attention"] == 1
    assert ops.launch_counts()["fused_decode_attention"] == 0
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()                          # retired lane → zero


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
