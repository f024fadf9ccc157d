"""repro_torch.cdmm.quantized held against repro.cdmm.quantized (JAX on the
CPU), bit for bit, at the shapes of examples/coded_inference.py: x (32,
256) @ w (256, 512) float32 from a numpy seed, N = 8, 0-4 dead workers."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.cdmm as J
import repro_torch.cdmm as P

N = 8
# dead workers per request, 0 to 4 of them (no prefix, so the decode reads a
# live set other than the first R workers)
DEAD = [(), (3,), (0, 5), (1, 4, 6), (0, 2, 5, 7)]


@pytest.fixture(scope="module")
def coded():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    w = rng.standard_normal((256, 512)).astype(np.float32)
    return J.CodedQuantMatmul(N=N, axis_name=None), P.CodedQuantMatmul(N, None, device="cpu"), x, w


def _mask(dead):
    m = np.ones(N, dtype=bool)
    m[list(dead)] = False
    return m


def test_quantize_lift_unlift_match_reference(coded):
    _, _, x, w = coded
    # exact .5 ties after scaling (amax 127 -> scale 1): half to even in both
    ties = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 126.5, -126.5, 1.5]], np.float32)
    for arr, axis in ((x, -1), (w, 0), (ties, -1), (np.zeros((3, 4), np.float32), 0)):
        jq, js = J.quantize_int8(jnp.asarray(arr), axis=axis)
        pq, ps = P.quantize_int8(torch.from_numpy(arr), axis=axis)
        assert pq.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
        lifted = P.lift_i8_to_ring(pq)
        assert lifted.dtype == torch.int32 and lifted.shape == pq.shape + (1,)
        np.testing.assert_array_equal(lifted.numpy().view(np.uint32),
                                      np.asarray(J.lift_i8_to_ring(jq)))
        np.testing.assert_array_equal(P.unlift_to_i32(lifted).numpy(),
                                      np.asarray(J.unlift_to_i32(J.lift_i8_to_ring(jq))))
    assert P.quantize_int8(torch.from_numpy(ties), -1)[0].tolist() == [[127, 2, -4, 0, 0, 126, -126, 2]]


def test_scale_is_the_true_quotient_not_the_reciprocal_product():
    """On the card, ``cuda_tensor / 127.0`` is computed as
    ``cuda_tensor * float32(1 / 127)``, whose last bit differs from the
    quotient the reference takes for some rows.  The inputs of
    tests/test_torch_card.py::test_coded_quant_matmul_on_the_card (seed 10)
    show it; quantize_int8 divides by a 0-dim tensor, which stays a true
    division on both devices."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    amax = x.abs().amax(dim=-1, keepdim=True)
    reciprocal = amax * (torch.tensor(1.0) / torch.tensor(127.0))
    true = amax / 127.0
    bits = lambda t: t.view(torch.int32) & 0xFFFFFFFF  # noqa: E731
    assert int((true != reciprocal).sum()) == 12
    assert (int(bits(true)[3, 0]), int(bits(reciprocal)[3, 0])) == (0x3CBD2345, 0x3CBD2344)
    _, scale = P.quantize_int8(x, axis=-1)
    _, jscale = J.quantize_int8(jnp.asarray(x.numpy()), axis=-1)
    assert torch.equal(bits(scale), bits(true))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32), np.asarray(jscale).view(np.uint32))


def test_scheme_matches_reference(coded):
    jc, pc, _, _ = coded
    assert pc.R == jc.R == 4
    assert pc.scheme.name == jc.scheme.name == "ep_rmfe1"
    assert pc.scheme.ring.degrees == jc.scheme.ring.degrees
    assert pc.scheme.partition == jc.scheme.partition


@pytest.fixture(scope="module")
def int8_operands(coded):
    _, _, x, w = coded
    jqx, _ = J.quantize_int8(jnp.asarray(x), axis=-1)
    jqw, _ = J.quantize_int8(jnp.asarray(w), axis=0)
    # the reference's integer path jitted once (the mask is an argument):
    # integer results do not depend on jit, and eager takes ~4 s a call
    jexact = jax.jit(lambda qx, qw, m: coded[0].exact_int_matmul(qx, qw, m))
    return jqx, jqw, jexact


@pytest.mark.parametrize("dead", DEAD, ids=lambda d: f"dead{len(d)}")
def test_exact_int_matmul_matches_reference(coded, int8_operands, dead):
    _, pc, _, _ = coded
    jqx, jqw, jexact = int8_operands
    qx, qw = (torch.from_numpy(np.array(a)) for a in (jqx, jqw))
    acc = pc.exact_int_matmul(qx, qw, None if not dead else torch.from_numpy(_mask(dead)))
    assert acc.dtype == torch.int32
    want = np.asarray(jexact(jqx, jqw, jnp.asarray(_mask(dead))))
    np.testing.assert_array_equal(acc.numpy(), want)
    # the exact integer product of the int8 operands (|acc| <= 256 * 127^2)
    np.testing.assert_array_equal(acc.numpy(), qx.numpy().astype(np.int64) @ qw.numpy())


@pytest.mark.parametrize("dead", [DEAD[0], DEAD[-1]], ids=lambda d: f"dead{len(d)}")
def test_call_matches_reference(coded, dead):
    """The float path against the reference run eagerly (jitted, XLA may
    reorder the two scale products of the dequantization, so jit and eager
    differ in the last bit; the port follows the eager order)."""
    jc, pc, x, w = coded
    y = pc(torch.from_numpy(x), torch.from_numpy(w), None if not dead else torch.from_numpy(_mask(dead)))
    assert y.dtype == torch.float32
    jy = np.asarray(jc(jnp.asarray(x), jnp.asarray(w), mask=None if not dead else jnp.asarray(_mask(dead))))
    np.testing.assert_array_equal(y.numpy().view(np.uint32), jy.view(np.uint32))


def test_call_bit_identical_under_dead_workers(coded):
    _, pc, x, w = coded
    y_ref = pc(torch.from_numpy(x), torch.from_numpy(w))
    for dead in DEAD[1:]:
        y = pc(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(_mask(dead)))
        assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32)), dead
    # quantization (not coding) is the only error source
    exact = torch.from_numpy(x).double() @ torch.from_numpy(w).double()
    assert float((y_ref.double() - exact).abs().max() / exact.abs().max()) < 0.02


def test_paths_of_later_slices_raise():
    # the sharded path is ported: outside a group bound to its axis (see
    # tests/test_torch_runtime.py for inside) it raises rather than run local
    cm = P.CodedQuantMatmul(N, "workers", device="cpu")
    q = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="bound to no group"):
        cm.exact_int_matmul(q, q.T.contiguous())
    # use_kernel is ignored on the CPU (it only pins a route on the card)
    assert P.CodedQuantMatmul(N, None, use_kernel=False, device="cpu").R == 4


# decode batch sizes: 2, 8 and 32 tokens through both projections of a
# narrow FFN (64 -> 96 and back) over N = 16 workers (GR(2^32, 4), the ring
# of gemma2-2b's coded FFN), 12 of them dead (a non-prefix live set)
DECODE_TOKENS = (2, 8, 32)
DECODE_LIVE = (1, 5, 10, 14)


@pytest.fixture(scope="module")
def coded16():
    jc = J.CodedQuantMatmul(N=16, axis_name=None)
    jexact = jax.jit(lambda qx, qw, m: jc.exact_int_matmul(qx, qw, m))
    mask = np.zeros(16, dtype=bool)
    mask[list(DECODE_LIVE)] = True
    return jexact, P.CodedQuantMatmul(16, None, device="cpu"), mask


@pytest.mark.parametrize("tokens", DECODE_TOKENS)
def test_decode_batch_sizes_match_reference(coded16, tokens):
    """The integer product against the reference's (jitted: integer results
    do not depend on jit) and the float output against it dequantized in
    the reference's eager order, acc * sx * sw, bit for bit, under 12 dead
    workers and without deaths."""
    jexact, pc, mask = coded16
    rng = np.random.default_rng(tokens)
    for d_in, d_out in ((64, 96), (96, 64)):
        x = rng.standard_normal((tokens, d_in)).astype(np.float32)
        w = rng.standard_normal((d_in, d_out)).astype(np.float32)
        jqx, jsx = J.quantize_int8(jnp.asarray(x), axis=-1)
        jqw, jsw = J.quantize_int8(jnp.asarray(w), axis=0)
        want = np.asarray(jexact(jqx, jqw, jnp.asarray(mask)))
        qx, qw = (torch.from_numpy(np.array(a)) for a in (jqx, jqw))
        acc = pc.exact_int_matmul(qx, qw, torch.from_numpy(mask))
        np.testing.assert_array_equal(acc.numpy(), want)
        y = pc(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(mask))
        jy = (want.astype(np.float32) * np.asarray(jsx)) * np.asarray(jsw)
        np.testing.assert_array_equal(y.numpy().view(np.uint32), jy.view(np.uint32))
        y_all = pc(torch.from_numpy(x), torch.from_numpy(w))
        assert torch.equal(y.view(torch.int32), y_all.view(torch.int32))


def test_decode_worker_products_go_to_simt_below_128_tokens(monkeypatch):
    """At gemma2-2b's FFN widths (src/repro/configs/gemma2_2b.py: d_model
    2304, d_ff 9216) the worker product (tokens / 2) x (d / 2) @ (d / 2) x
    (f / 2) over GR(2^32, 4) is simt's below 128 tokens and tc's at 128:
    every ring matmul of the call is routed as on the card (the kernels
    stood in for by zeros), and the worker product's route recorded."""
    from repro_torch.kernels import ops

    seen = []
    monkeypatch.setattr(ops, "kernel_auto_enabled", lambda ring, x: True)

    def run_route(route, A, B, ring, config=None):
        seen.append((route, tuple(A.shape), tuple(B.shape)))
        return torch.zeros(A.shape[:-2] + (B.shape[-2], ring.D), dtype=torch.int32)

    monkeypatch.setattr(ops, "run_route", run_route)
    pc = P.CodedQuantMatmul(16, None, device="cpu")
    gen = torch.Generator().manual_seed(0)
    mask = torch.zeros(16, dtype=torch.bool)
    mask[list(DECODE_LIVE)] = True
    for tokens in (2, 8, 32, 126, 128):
        for d_in, d_out in ((2304, 9216), (9216, 2304)):
            seen.clear()
            x = torch.randn((tokens, d_in), generator=gen)
            pc(x, torch.randn((d_in, d_out), generator=gen), mask)
            workers = [c for c in seen if c[1][0] == 16 and c[1][-2] == d_in // 2]
            assert len(workers) == 1 and workers[0][1:] == ((16, tokens // 2, d_in // 2, 4),
                                                            (16, d_in // 2, d_out // 2, 4))
            assert workers[0][0] == ("simt" if tokens < 128 else "tc"), (tokens, d_in)
            assert sorted(c[0] for c in seen if c not in workers) == ["skinny"] * 6
