"""The port's flash attention against the JAX package's Pallas kernels.

CPU cases: the plain torch versions (both forwards, the backward) against
``da3slam_tpu``'s ``flash_attention`` run through the Pallas interpreter, on
the same numpy inputs; the differentiable entry point (``FlashAttention``)
under gradcheck and through ``multi_head_attention``.  CUDA cases (marker
``cuda``, skipped without a card) hold each hand-written kernel against its
plain version on the card.  JAX is imported inside the CPU cases only, so
the CUDA cases run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from da3slam_tpu_torch.ops.attention import multi_head_attention
from da3slam_tpu_torch.ops.flash_attention import (
    BWD_F32_ROWS,
    BWD_F32_TILE,
    BWD_TILE,
    BWD_TILE_DKV,
    FWD_F32_ROWS,
    FWD_F32_TILE,
    LN2,
    LOG2E,
    STABLE_BLOCK_K,
    TF32_PAD,
    attention_delta,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_bound,
    flash_attention_bound_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference,
    flash_attention_stable,
    flash_attention_stable_reference,
)

torch.set_num_threads(2)
COUNTED = (flash_attention_bound, flash_attention_stable, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)


def rand_qkv(seed, B, S, H, D=64, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    return q * scale, k, v


def rand_grad(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jdt(dtype):
    import jax.numpy as jnp

    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas kernels through the interpreter (CPU)."""
    from jax.experimental import pallas as pl

    with mock.patch.object(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)):
        yield


def jax_forward(q, k, v, dtype, stable):
    """The JAX package's forward in interpret mode: (O, lse [BH, S])."""
    import jax.numpy as jnp

    from da3slam_tpu.ops.flash_attention import _flash_forward

    jdt = _jdt(dtype)
    with pallas_interpret():
        o, res = _flash_forward(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                128, 128, stable=stable)
    S = q.shape[1]
    return np.asarray(o, np.float32), np.asarray(res[-1][:, :S, 0])


def jax_bound(q, k, v, dtype):
    """The JAX package's max-free forward in interpret mode: (O, lse [BH, S])."""
    return jax_forward(q, k, v, dtype, stable=False)


def jax_backward(q, k, v, g, dtype):
    """(dq, dk, dv) from the JAX package's custom VJP (the Pallas dq and
    dk/dv kernels) in interpret mode, under the bound forward."""
    import jax
    import jax.numpy as jnp

    from da3slam_tpu.ops.flash_attention import flash_attention as jflash

    jdt = _jdt(dtype)

    def f(q, k, v):
        return jflash.__wrapped__(q, k, v, block_q=128, block_k=128, stable=False)

    with pallas_interpret():
        _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(x, np.float32) for x in grads]


def torch_inputs(dtype, *arrays, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=dtype) for x in arrays]


def port_bound(q, k, v, dtype):
    o, lse = flash_attention_bound(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)))
    return o.float().numpy(), lse.numpy()


class TestPlainMatchesJax:
    # f32: same formula, same rounding points; only the summation order of
    # the logits and of p·V differs (~1e-7 relative)
    @pytest.mark.parametrize("S", [128, 300])
    def test_f32(self, S):
        q, k, v = rand_qkv(20, 2, S, 3)
        o_j, lse_j = jax_bound(q, k, v, torch.float32)
        o_t, lse_t = port_bound(q, k, v, torch.float32)
        np.testing.assert_allclose(o_t, o_j, atol=2e-6)
        np.testing.assert_allclose(lse_t, lse_j, atol=2e-5)

    def test_bf16(self):
        # bf16: a p near a rounding boundary can round the other way, and the
        # output is rounded to bf16 (1 ulp = 2^-8 relative): 2e-2 is the JAX
        # package's own bf16 bound for this forward
        q, k, v = rand_qkv(21, 1, 256, 2)
        o_j, _ = jax_bound(q, k, v, torch.bfloat16)
        o_t, _ = port_bound(q, k, v, torch.bfloat16)
        np.testing.assert_allclose(o_t, o_j, atol=2e-2)

    def test_underflow_pathology_gives_zeros(self):
        """30x-scaled diffuse q: the bound exceeds every logit by more than
        f32's exponent range, every p flushes to 0 and both give zeros (not
        NaN)."""
        q, k, v = rand_qkv(23, 1, 128, 1, scale=30.0)
        o_j, _ = jax_bound(q, k, v, torch.float32)
        o_t, _ = port_bound(q, k, v, torch.float32)
        np.testing.assert_array_equal(o_j, 0.0)
        np.testing.assert_array_equal(o_t, 0.0)

    def test_matches_exact_softmax_attention(self):
        """At layernormed scales the bound forward is softmax attention."""
        q, k, v = rand_qkv(24, 2, 200, 2)
        o_t, _ = port_bound(q, k, v, torch.float32)
        qt, kt, vt = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
        p = torch.softmax(qt @ kt.transpose(-1, -2) / 8.0, dim=-1)
        ref = (p @ vt).transpose(1, 2).numpy()
        np.testing.assert_allclose(o_t, ref, atol=5e-6)


class TestDispatch:
    def test_cpu_never_launches_the_kernel(self):
        q, k, v = (torch.from_numpy(x) for x in rand_qkv(25, 2, 64, 2))
        before = flash_attention_bound.launches
        out = multi_head_attention(q, k, v)
        assert flash_attention_bound.launches == before
        ref, _ = flash_attention_bound_reference(q, k, v)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)

    def test_unsupported_device_raises(self):
        q = torch.zeros(1, 4, 1, 64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attention_bound(q, q, q)

    @pytest.mark.parametrize("stable", [False, True])
    def test_cpu_backward_runs_the_plain_versions(self, stable):
        """On CPU tensors both directions of the Function are the plain
        versions, bit for bit, and no kernel is counted."""
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in rand_qkv(26, 2, 70, 2))
        g = torch.from_numpy(rand_grad(27, q.shape))
        before = [f.launches for f in COUNTED]
        flash_attention(q, k, v, stable=stable).backward(g)
        assert [f.launches for f in COUNTED] == before
        fwd = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o, lse = fwd(q.detach(), k.detach(), v.detach())
        ref = flash_attention_backward_reference(q.detach(), k.detach(), v.detach(), o, lse, g)
        for t, r in zip((q, k, v), ref):
            torch.testing.assert_close(t.grad, r, rtol=0, atol=0)

    def test_no_grad_keeps_no_graph(self):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in rand_qkv(28, 1, 40, 2))
        with torch.no_grad():
            out = multi_head_attention(q, k, v)
        assert out.grad_fn is None and not out.requires_grad


class TestStablePlainMatchesJax:
    # f32: same formula, same rounding points; the JAX kernel's online
    # recurrence and the plain one both step by 128 keys (STABLE_BLOCK_K, the
    # bf16 CUDA kernel's key tile) and differ in the order of f32 sums only
    # (~1e-7 relative)
    @pytest.mark.parametrize("S", [128, 300])
    def test_f32(self, S):
        q, k, v = rand_qkv(30, 2, S, 3)
        o_j, lse_j = jax_forward(q, k, v, torch.float32, stable=True)
        o_t, lse_t = (x.float().numpy() for x in flash_attention_stable(*torch_inputs(torch.float32, q, k, v)))
        np.testing.assert_allclose(o_t, o_j, atol=2e-6)
        np.testing.assert_allclose(lse_t, lse_j, atol=1e-5)

    @pytest.mark.parametrize("S", [256, 300])
    def test_bf16(self, S):
        # p is rounded to bf16 against the running max after each 128-key
        # block in JAX and here alike, so the two round p at the same points
        # and differ by f32 summation order and the output's rounding to bf16:
        # one ulp, 2^-8·max|O| (a quarter of chip_smoke.BF16_REL_TOL, which
        # they were held to while the plain version stepped by 16 keys)
        assert STABLE_BLOCK_K == 128
        q, k, v = rand_qkv(31, 1, S, 2)
        o_j, _ = jax_forward(q, k, v, torch.bfloat16, stable=True)
        o_t, _ = flash_attention_stable(*torch_inputs(torch.bfloat16, q, k, v))
        np.testing.assert_allclose(o_t.float().numpy(), o_j,
                                   atol=2.0 ** -8 * np.abs(o_j).max())

    def test_plain_runs_the_kernels_blocked_recurrence(self):
        """The plain stable forward is the kernel's recurrence: in f64 (p not
        rounded) it is exact softmax attention (1e-12), and in bf16 it matches
        a key-block-by-key-block loop that rounds p against the running max
        and rescales by exp2(m_prev − m_new), as the CUDA kernel does.  The
        two differ in f32 summation order only; the bf16 output may then
        round one ulp (2^-8·max|O|) the other way."""
        q, k, v = rand_qkv(32, 1, 300, 2)
        o64, lse64 = flash_attention_stable_reference(*torch_inputs(torch.float64, q, k, v))
        qt, kt, vt = (torch.from_numpy(x).double().transpose(1, 2) for x in (q, k, v))
        s = qt @ kt.transpose(-1, -2) * (LOG2E / 8.0)
        ref = (torch.softmax(s * LN2, -1) @ vt).transpose(1, 2)
        torch.testing.assert_close(o64, ref, rtol=0, atol=1e-12)
        torch.testing.assert_close(lse64, torch.logsumexp(s * LN2, -1).reshape(2, 300) / LN2,
                                   rtol=0, atol=1e-12)

        qb, kb, vb = torch_inputs(torch.bfloat16, q, k, v)
        o_t, lse_t = flash_attention_stable_reference(qb, kb, vb)
        for h in range(2):
            qs = (qb[0, :, h].float() * (LOG2E / 8.0)).bfloat16().float()
            kf, vf = kb[0, :, h].float(), vb[0, :, h].float()
            m = torch.full((300,), -1e30)
            acc, den = torch.zeros(300, 64), torch.zeros(300)
            for j0 in range(0, 300, STABLE_BLOCK_K):
                sb = qs @ kf[j0:j0 + STABLE_BLOCK_K].T
                m_new = torch.maximum(m, sb.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(sb - m_new[:, None]).bfloat16().float()
                acc = alpha[:, None] * acc + p @ vf[j0:j0 + STABLE_BLOCK_K]
                den = alpha * den + p.sum(-1)
                m = m_new
            o_loop = acc / den[:, None]
            torch.testing.assert_close(o_t[0, :, h].float(), o_loop, rtol=0,
                                       atol=2.0 ** -8 * o_loop.abs().max().item())
            torch.testing.assert_close(lse_t[h], m + torch.log2(den), rtol=0, atol=1e-5)

    def test_30x_scaled_q_stays_exact(self):
        """The input where the bound forward gives zeros: the stable forward
        is softmax attention.  lse ~ 350 here, so 5e-5 is a few f32 ulps."""
        q, k, v = rand_qkv(23, 1, 128, 1, scale=30.0)
        o_j, lse_j = jax_forward(q, k, v, torch.float32, stable=True)
        o_t, lse_t = flash_attention_stable(*torch_inputs(torch.float32, q, k, v))
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=2e-6)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=5e-5)
        assert np.abs(o_t.numpy()).max() > 0.5
        o_b, _ = flash_attention_bound(*torch_inputs(torch.float32, q, k, v))
        assert (o_b == 0).all()


class TestBackwardPlainMatchesJax:
    @pytest.mark.parametrize("S,dtype", [(128, torch.float32), (300, torch.float32),
                                         (256, torch.bfloat16), (300, torch.bfloat16)])
    def test_matches_jax_vjp(self, S, dtype):
        """f32: the same sums in another order, ≤ 1e-6 measured; 1e-5.  bf16:
        dz, p and the outputs are rounded to bf16 at the same points, and a
        value at a rounding boundary can go either way: one bf16 ulp of the
        largest gradient, 2^-7·max|g|."""
        q, k, v = rand_qkv(S, 2, S, 3)
        g = rand_grad(S + 1, q.shape)
        jg = jax_backward(q, k, v, g, dtype)
        tq, tk, tv, tg = torch_inputs(dtype, q, k, v, g)
        o, lse = flash_attention_bound_reference(tq, tk, tv)
        tgrads = flash_attention_backward_reference(tq, tk, tv, o, lse, tg)
        for name, a, b in zip("qkv", tgrads, jg):
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * np.abs(b).max()
            np.testing.assert_allclose(a.float().numpy(), b, atol=tol, err_msg=f"d{name}")

    def test_one_backward_serves_both_forwards(self):
        """lse is the same quantity under either forward (the JAX package's
        own pin, tests/test_flash_attention.py: 2e-5)."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(33, 1, 256, 2))
        g = torch.from_numpy(rand_grad(34, q.shape))
        grads = [flash_attention_backward_reference(q, k, v, *fwd(q, k, v), g)
                 for fwd in (flash_attention_bound_reference, flash_attention_stable_reference)]
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


class TestDifferentiable:
    @pytest.mark.parametrize("stable", [False, True])
    def test_gradcheck_float64(self, stable):
        rng = np.random.default_rng(35)
        q, k, v = (torch.from_numpy(rng.normal(size=(1, 11, 2, 8))).requires_grad_()
                   for _ in range(3))
        assert torch.autograd.gradcheck(lambda *a: flash_attention(*a, stable=stable), (q, k, v))

    def test_grads_through_multi_head_attention_match_jax(self):
        """jax.grad of the JAX package's multi_head_attention (XLA softmax
        attention on the CPU) against the port's (the plain bound forward and
        backward): the same function in f32, 1e-5."""
        import jax
        import jax.numpy as jnp

        from da3slam_tpu.ops.attention import multi_head_attention as jmha

        q, k, v = rand_qkv(36, 2, 150, 2)
        w = rand_grad(37, q.shape)
        jg = jax.grad(lambda q, k, v: jnp.sum(jmha(q, k, v) * w), argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        (multi_head_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
        for t, j in zip((tq, tk, tv), jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5)


class TestDroppedTileBreaksTheSmokeBound:
    """chip_smoke.py holds each kernel gradient to ``grad_bound`` of the
    plain one; a kernel that skipped the ragged last key tile (dq) or q tile
    (dk/dv) must break it.  The smoke checks the same on the card at its own
    shapes."""

    @pytest.mark.parametrize("dtype,shape", [(torch.float32, (2, 300, 3, 64)),
                                             (torch.bfloat16, (1, 1301, 2, 64))])
    def test_bound_catches_a_dropped_tile(self, dtype, shape):
        q, k, v, g = torch_inputs(dtype, *rand_qkv(38, *shape[:3]), rand_grad(39, shape))
        o, lse = flash_attention_bound_reference(q, k, v)
        delta = attention_delta(o, g)
        grads = (flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                 *flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        errs = chip_smoke.dropped_tile_errors(q, k, v, g, lse, delta, grads)
        for name, err, ref in zip("qkv", errs, grads):
            assert err > chip_smoke.grad_bound(ref), f"d{name}: {err}"

    @pytest.mark.parametrize("stable", [False, True])
    @pytest.mark.parametrize("shape", [(2, 300, 3, 64), (1, 1301, 2, 64)])
    def test_bounds_catch_a_dropped_forward_tile(self, shape, stable):
        """chip_smoke.py holds each f32 forward to fwd_bound and LSE_TOL; the
        plain forward without the f32 kernel's last (ragged) 32-key tile must
        break both."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(39, *shape[:3]))
        ref = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o, lse = ref(q, k, v)
        cut = chip_smoke.dropped_key_tile_errors(q, k, v, o, lse)
        assert cut["o"] > chip_smoke.fwd_bound(o) and cut["lse"] > chip_smoke.LSE_TOL, cut
        assert chip_smoke.dropped_key_tile_errors(q[:, :32], k[:, :32], v[:, :32], o, lse) is None


TILE_K = STABLE_BLOCK_K  # the bf16 kernel's key tile (kTileK in flash_attn_fwd.cu)


def tile_model(q, k, v, stable, mask=True):
    """The bf16 CUDA kernel's schedule in plain torch, one (batch, head) at a
    time: whole key tiles of TILE_K keys, the rows past S zero-filled (as TMA
    delivers them) and multiplied like any other; in the last tile p is forced
    to 0 in columns >= S - k0 (``mask``) before the sum and the P·V product,
    and the score to -inf before the stable mode's per-tile running max.
    Returns (O, lse [B*H, S]).  ``mask=False`` is the kernel without that step.
    """
    B, S, H, D = q.shape
    n_tiles = -(-S // TILE_K)
    pad = n_tiles * TILE_K - S
    qs = (q.float() * (LOG2E / D ** 0.5)).to(q.dtype).float()
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    o = torch.empty(B, S, H, D)
    lse = torch.empty(B, H, S)
    for b in range(B):
        for h in range(H):
            qh = qs[b, :, h]
            if stable:
                m = torch.full((S,), -1e30)
            else:
                m = qh.norm(dim=-1) * k[b, :, h].float().norm(dim=-1).max()
            acc, den = torch.zeros(S, D), torch.zeros(S)
            for t in range(n_tiles):
                rows = slice(t * TILE_K, (t + 1) * TILE_K)
                sc = qh @ kp[b, rows, h].T
                if mask:
                    sc[:, S - t * TILE_K:] = -torch.inf
                if stable:
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    acc, den, m = acc * alpha[:, None], den * alpha, m_new
                pt = torch.exp2(sc - m[:, None]).to(v.dtype).float()
                acc = acc + pt @ vp[b, rows, h]
                den = den + pt.sum(-1)
            den = den.clamp_min(1e-30)
            o[b, :, h] = acc / den[:, None]
            lse[b, h] = m + torch.log2(den)
    return o.to(q.dtype), lse.reshape(B * H, S)


class TestTileModel:
    """The bf16 kernel's tile schedule, modelled on the CPU, is the plain
    versions' function; without the mask of the padded keys it is not."""

    @pytest.mark.parametrize("stable", [False, True])
    @pytest.mark.parametrize("S", [1, 127, 128, 129, 300])
    def test_masked_tiles_match_plain(self, S, stable):
        """Same rounding points (q', p per tile); the order of f32 sums
        differs, and the bf16 output may round one ulp the other way."""
        q, k, v = torch_inputs(torch.bfloat16, *rand_qkv(50 + S, 2, S, 2))
        ref = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o_ref, lse_ref = ref(q, k, v)
        o, lse = tile_model(q, k, v, stable)
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=0,
                                   atol=2.0 ** -8 * o_ref.float().abs().max().item())
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("stable", [False, True])
    def test_unmasked_padding_breaks_the_bounds(self, stable):
        """The padded-key trap: a zero-filled key scores 0, and exp2(0 - m) is
        not 0.  At S = 129 the last tile holds one key and 127 zero rows:
        left in, they move lse past chip_smoke.LSE_TOL and O past fwd_bound."""
        q, k, v = torch_inputs(torch.bfloat16, *rand_qkv(60, 2, 129, 2))
        ref = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o_ref, lse_ref = ref(q, k, v)
        o, lse = tile_model(q, k, v, stable, mask=False)
        assert (lse - lse_ref).abs().max().item() > chip_smoke.LSE_TOL
        assert (o.float() - o_ref.float()).abs().max().item() > chip_smoke.fwd_bound(o_ref)


def anti_aligned_inputs(S, B=1, H=2, seed=90, dtype=torch.bfloat16, spread=None):
    """q, k, v, dO (bf16 unless ``dtype``) whose every logit is near -216 (q
    opposite to keys that all point one way), with O, lse and Δ from the plain
    stable forward (the bound forward's shift would underflow every p): lse ≈
    -216 + log2 S, so a zero-filled key's p = exp2(0 - lse) overflows f32.

    With keys this alike, dq = Σ dz·k/√D is a cancellation (Σ_j dz_ij = 0) of
    terms ~12x its size, and f32's own rounding of s (|s| ~ 216) shows in it
    at ~2e-4 of max|dq|.  ``spread``: each key gets a component orthogonal to
    the common direction of that norm times |u| instead (keys ⟂ u change no
    logit), so that dq is no cancellation and f32 bounds apply."""
    rng = np.random.default_rng(seed)
    u = np.full(64, 0.125, np.float32)
    noise = rng.normal(size=(B, S, H, 64)).astype(np.float32)
    if spread is None:
        k = u + 0.01 * noise
    else:
        w = noise - (noise @ u)[..., None] * u / (u @ u)
        k = u + spread * w / np.linalg.norm(w, axis=-1, keepdims=True)
    q = -1200.0 * u + rng.normal(size=(B, S, H, 64)).astype(np.float32)
    v, g = (rng.normal(size=(B, S, H, 64)).astype(np.float32) for _ in range(2))
    q, k, v, g = torch_inputs(dtype, q, k, v, g)
    o, lse = flash_attention_stable_reference(q, k, v)
    return q, k, v, g, lse, attention_delta(o, g)


# a gradient that is 0 but for the order of f32 sums (dq of a one-key sequence)
DQ_NOISE = 1e-5


def bwd_tile_model(q, k, v, do, lse, delta, mask=True):
    """The bf16 backward kernels' schedule in plain torch, one (batch, head)
    at a time: the other side in whole tiles (BWD_TILE keys for dq,
    BWD_TILE_DKV q rows for dk/dv), the rows past S zero-filled (as TMA
    delivers them) and multiplied like any other; p and dz
    rounded to bf16 a tile, the gradients summed in f32 over the tiles.  dq
    forces the scores of the last tile's columns >= S - k0 to -inf (``mask``),
    dk/dv reads lse = +inf and Δ = 0 for its padded q rows (``mask``; 0 and 0
    without).  Returns (dq, dk, dv).  ``mask=False`` is the kernels without
    those steps."""
    B, S, H, D = q.shape
    pad = -(-S // BWD_TILE) * BWD_TILE - S  # BWD_TILE_DKV divides BWD_TILE

    def padded(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))

    def rows(x, value):
        return torch.nn.functional.pad(x.reshape(B, H, S), (0, pad), value=value)

    qs = (q.float() * (LOG2E / D ** 0.5)).to(q.dtype).float()
    qp, kp, vp, gp = padded(qs.to(q.dtype)), padded(k), padded(v), padded(do)
    lse, delta = lse.reshape(B, H, S), delta.reshape(B, H, S)
    lse_p, delta_p = rows(lse, torch.inf if mask else 0.0), rows(delta, 0.0)
    dq, dk, dv = (torch.zeros(B, S, H, D) for _ in range(3))
    for b in range(B):
        for h in range(H):
            # dq: own rows are q, a tile holds keys
            for t in range(-(-S // BWD_TILE)):
                tile = slice(t * BWD_TILE, (t + 1) * BWD_TILE)
                sc = qs[b, :, h] @ kp[b, tile, h].T
                if mask:
                    sc[:, S - t * BWD_TILE:] = -torch.inf
                p = torch.exp2(sc - lse[b, h][:, None])
                dz = p * (do[b, :, h].float() @ vp[b, tile, h].T - delta[b, h][:, None])
                dq[b, :, h] += dz.to(q.dtype).float() @ kp[b, tile, h]
            # dk/dv: own rows are keys, a tile holds q rows
            for t in range(-(-S // BWD_TILE_DKV)):
                tile = slice(t * BWD_TILE_DKV, (t + 1) * BWD_TILE_DKV)
                sc = k[b, :, h].float() @ qp[b, tile, h].T
                p = torch.exp2(sc - lse_p[b, h, tile][None, :])
                dz = p * (v[b, :, h].float() @ gp[b, tile, h].T - delta_p[b, h, tile][None, :])
                dv[b, :, h] += p.to(q.dtype).float() @ gp[b, tile, h]
                dk[b, :, h] += dz.to(q.dtype).float() @ qp[b, tile, h]
    return (dq / D ** 0.5).to(q.dtype), (LN2 * dk).to(q.dtype), dv.to(q.dtype)


class TestBackwardTileModel:
    """The bf16 backward kernels' tile schedule, modelled on the CPU, is the
    plain versions' function; the padded rows multiply zeros, so their mask
    matters exactly where p overflows."""

    @pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 300])
    def test_masked_tiles_match_plain(self, S):
        """Same rounding points (q', p and dz a tile); the f32 sums run tile by
        tile, and a bf16 output may round one step the other way: 2^-7·max|g|
        (TestBackwardPlainMatchesJax's bound).  At S = 1 dq is pure cancellation
        (dz = dO·v - dO·O with O = v): 0 up to f32 noise, held to DQ_NOISE."""
        q, k, v, g = torch_inputs(torch.bfloat16, *rand_qkv(150 + S, 2, S, 2),
                                  rand_grad(151 + S, (2, S, 2, 64)))
        o, lse = flash_attention_bound_reference(q, k, v)
        delta = attention_delta(o, g)
        refs = flash_attention_backward_reference(q, k, v, o, lse, g)
        for name, a, r in zip("qkv", bwd_tile_model(q, k, v, g, lse, delta), refs):
            torch.testing.assert_close(
                a.float(), r.float(), rtol=0,
                atol=max(2.0 ** -7 * r.float().abs().max().item(), DQ_NOISE),
                msg=lambda m, name=name: f"d{name}: {m}")

    @pytest.mark.parametrize("S", [65, 129, 300])
    def test_masked_tiles_survive_overflowing_padding(self, S):
        """Every logit near -216: the masked model is still the plain backward."""
        q, k, v, g, lse, delta = anti_aligned_inputs(S)
        refs = (flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                *flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        for name, a, r in zip("qkv", bwd_tile_model(q, k, v, g, lse, delta), refs):
            assert torch.isfinite(a).all(), f"d{name}"
            assert (a.float() - r.float()).abs().max().item() <= chip_smoke.grad_bound(r), name

    def test_unmasked_padding_breaks_the_bound(self):
        """The padded-key trap of dq: a zero-filled key scores 0, p = exp2(0 -
        lse) overflows, dz is ±inf, and inf times the key's zeros is NaN in
        every row.  dk/dv's padded q rows read lse = Δ = 0 without the mask:
        p = 1 and dz = 0 against zero rows, which adds nothing, so their mask
        guards only against what lies past the end of lse."""
        q, k, v, g, lse, delta = anti_aligned_inputs(129)
        ref = flash_attention_bwd_dq_reference(q, k, v, g, lse, delta)
        dq, dk, dv = bwd_tile_model(q, k, v, g, lse, delta, mask=False)
        err = (dq.float() - ref.float()).abs().max().item()
        assert not err <= chip_smoke.grad_bound(ref)  # NaN
        assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (10 mantissa bits,
    to nearest, ties away from zero), on the f32 bits, the 13 dropped bits 0."""
    b = (x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF) + 0x1000
    b = b & 0xFFFFE000
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


def split_tf32(x):
    """x = hi + lo + O(2^-22·|x|), both TF32 (split_tf32 in flash_wgmma.cuh)."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def mm_tf32(a, b, terms=3):
    """a @ b as the f32 kernels take it on the tensor cores: lo·hi + hi·lo +
    hi·hi of the TF32 halves (``terms=1``: hi·hi alone), each product of two
    TF32 values exact in f32, summed in f32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


# The f32 kernels' register layouts (flash_attn_bwd.cu, flash_wgmma.cuh), per
# k8 step of 8 columns: the score accumulator holds element e of a thread t
# (lane) at row t/4 + 8(e//2), column 2(t%4) + e%2; the TF32 A fragment's slot
# f at row t/4 + 8(f%2), inner index t%4 + 4(f//2); split_fragments puts
# element FRAG_FROM_ACC[f] into slot f.
FRAG_FROM_ACC = (0, 2, 1, 3)
# position p of each group of 8 in the pre-pass's transposed copies holds row
# TF32_ROW_AT[p] (tf32_row_at in flash_attn_bwd.cu)
TF32_ROW_AT = (0, 2, 4, 6, 1, 3, 5, 7)


def fragment_columns():
    """inner index of the A fragment -> the set of score columns it receives,
    over the 32 lanes."""
    cols = {}
    for lane in range(32):
        t = lane % 4
        for f, e in enumerate(FRAG_FROM_ACC):
            assert f % 2 == e // 2, "slot and element lie in one row"
            cols.setdefault(t + 4 * (f // 2), set()).add(2 * t + e % 2)
    return cols


def tf32_bwd_tile_model(q, k, v, do, lse, delta, terms=3, mask=True):
    """The f32 backward kernels' schedule and numerics in plain torch, one
    (batch, head) at a time: the other side in tiles of BWD_F32_TILE rows, the
    rows past S zero-filled (the pre-pass's padding) and multiplied like any
    other; every product as mm_tf32 (``terms=1``: one TF32 product), the
    gradient products' summed index in the kernels' order (the A columns as
    the fragments hand them over, the B rows as the pre-pass permutes its
    transposed copies); dq forces the last tile's scores of columns >= S - k0
    to -inf (``mask``), dk/dv reads (lse, Δ) = (+inf, 0) for its padded q rows
    (``mask``; (0, 0) without); the gradients summed in f32 tile by tile.
    Returns (dq, dk, dv)."""
    B, S, H, D = q.shape
    T = BWD_F32_TILE
    n = -(-S // T)
    pad = n * T - S
    into_slot = {i: c.pop() for i, c in fragment_columns().items()}
    a_cols = [8 * (c // 8) + into_slot[c % 8] for c in range(T)]
    b_rows = [8 * (c // 8) + TF32_ROW_AT[c % 8] for c in range(T)]

    def gradient_product(a, b):  # a [rows, T] in score order, b [T, D]
        return mm_tf32(a[:, a_cols], b[b_rows], terms)

    def padded(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))

    qs = q.float() * (LOG2E / D ** 0.5)
    qp, kp, vp, gp = padded(qs), padded(k), padded(v), padded(do)
    lse, delta = lse.reshape(B, H, S), delta.reshape(B, H, S)
    lse_p = torch.nn.functional.pad(lse, (0, pad), value=torch.inf if mask else 0.0)
    delta_p = torch.nn.functional.pad(delta, (0, pad), value=0.0)
    dq, dk, dv = (torch.zeros(B, S, H, D) for _ in range(3))
    for b in range(B):
        for h in range(H):
            for t in range(n):  # dq: own rows are q, a tile holds keys
                tile = slice(t * T, (t + 1) * T)
                sc = mm_tf32(qs[b, :, h], kp[b, tile, h].T, terms)
                if mask:
                    sc[:, S - t * T:] = -torch.inf
                p = torch.exp2(sc - lse[b, h][:, None])
                dz = p * (mm_tf32(do[b, :, h], vp[b, tile, h].T, terms) - delta[b, h][:, None])
                dq[b, :, h] += gradient_product(dz, kp[b, tile, h])
            for t in range(n):  # dk/dv: own rows are keys, a tile holds q rows
                tile = slice(t * T, (t + 1) * T)
                p = torch.exp2(mm_tf32(k[b, :, h], qp[b, tile, h].T, terms)
                               - lse_p[b, h, tile][None, :])
                dz = p * (mm_tf32(v[b, :, h], gp[b, tile, h].T, terms)
                          - delta_p[b, h, tile][None, :])
                dv[b, :, h] += gradient_product(p, gp[b, tile, h])
                dk[b, :, h] += gradient_product(dz, qp[b, tile, h])
    return dq / D ** 0.5, LN2 * dk, dv


class TestTf32BackwardModel:
    """The f32 backward kernels' 3xTF32 numerics and tile schedule, modelled
    on the CPU, are the plain versions' function within chip_smoke's f32
    bound; one TF32 product is not."""

    def test_tf32_rounding(self):
        x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                          1.0 + 2.0 ** -11 - 2.0 ** -23, torch.finfo(torch.float32).max, 0.0])
        want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
                             1.0, torch.inf, 0.0])
        torch.testing.assert_close(tf32(x), want, rtol=0, atol=0)
        y = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
        hi, lo = split_tf32(y)
        assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((hi + lo - y).abs() <= 2.0 ** -22 * y.abs()).all()
        assert ((hi - y).abs() <= 2.0 ** -11 * y.abs()).all()

    def test_fragment_order_pairs_scores_with_the_prepass_rows(self):
        """The TF32 A fragment takes a score column other than its inner index
        (2t where it reads t); the transposed copies' rows follow the same
        order, so each fragment value meets its own row.  The constants are
        the ones flash_attn_bwd.cu compiles (the pairing from flash_tf32.cuh,
        which it shares with the f32 forwards)."""
        from da3slam_tpu_torch.ops import flash_attention as fa

        cols = fragment_columns()
        assert sorted(cols) == list(range(8))
        assert all(len(c) == 1 for c in cols.values()), "one column an inner index, every lane"
        assert tuple(cols[i].pop() for i in range(8)) == TF32_ROW_AT
        assert TF32_ROW_AT == tuple(2 * (p & 3) + (p >> 2) for p in range(8))
        shared = (fa._CSRC / "flash_tf32.cuh").read_text()
        assert "constexpr int kFragFromAcc[4] = {0, 2, 1, 3};" in shared
        assert "int tf32_row_at(int p) { return 2 * (p & 3) + (p >> 2); }" in shared
        text = (fa._CSRC / "flash_attn_bwd.cu").read_text()
        assert '#include "flash_tf32.cuh"' in text
        assert f"constexpr int kF32N = {BWD_F32_TILE};" in text
        assert f"constexpr int kF32Rows = {BWD_F32_ROWS};" in text

    @pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 300])
    def test_model_matches_plain(self, S):
        """Measured ~1e-6 of max|g| (3xTF32 keeps ~21 bits of a product);
        held to chip_smoke.grad_bound, 1e-4.  At S = 1 dq is cancellation noise
        around 0: DQ_NOISE."""
        q, k, v, g = torch_inputs(torch.float32, *rand_qkv(250 + S, 2, S, 2),
                                  rand_grad(251 + S, (2, S, 2, 64)))
        o, lse = flash_attention_bound_reference(q, k, v)
        delta = attention_delta(o, g)
        refs = flash_attention_backward_reference(q, k, v, o, lse, g)
        for name, a, r in zip("qkv", tf32_bwd_tile_model(q, k, v, g, lse, delta), refs):
            err = (a - r).abs().max().item()
            assert err <= max(chip_smoke.grad_bound(r), DQ_NOISE), f"d{name}: {err}"

    @pytest.mark.parametrize("S", [33, 65, 129, 300])
    def test_model_survives_overflowing_padding(self, S):
        """Every logit near -216: the masked model is still the plain backward."""
        q, k, v, g, lse, delta = anti_aligned_inputs(S, dtype=torch.float32, spread=1.0)
        refs = (flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                *flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        for name, a, r in zip("qkv", tf32_bwd_tile_model(q, k, v, g, lse, delta), refs):
            assert torch.isfinite(a).all(), f"d{name}"
            assert (a - r).abs().max().item() <= chip_smoke.grad_bound(r), name

    def test_unmasked_padding_breaks_the_bound(self):
        """As in bf16: without the mask a padded key's p overflows into dq."""
        q, k, v, g, lse, delta = anti_aligned_inputs(129, dtype=torch.float32, spread=1.0)
        ref = flash_attention_bwd_dq_reference(q, k, v, g, lse, delta)
        dq, _, _ = tf32_bwd_tile_model(q, k, v, g, lse, delta, mask=False)
        assert not (dq - ref).abs().max().item() <= chip_smoke.grad_bound(ref)

    def test_one_tf32_product_breaks_the_bound(self):
        """hi·hi alone keeps ~11 bits: its error in s (2^-11·|q'||k|) moves p
        by ~0.4%, which each gradient shows at ~7e-4 of max|g| (3xTF32:
        1.2e-6), several times grad_bound: the bound tells the designs apart."""
        q, k, v, g = torch_inputs(torch.float32, *rand_qkv(260, 2, 300, 2),
                                  rand_grad(261, (2, 300, 2, 64)))
        o, lse = flash_attention_bound_reference(q, k, v)
        delta = attention_delta(o, g)
        refs = flash_attention_backward_reference(q, k, v, o, lse, g)
        for name, a, r in zip("qkv", tf32_bwd_tile_model(q, k, v, g, lse, delta, terms=1), refs):
            assert (a - r).abs().max().item() > 4 * chip_smoke.grad_bound(r), f"d{name}"


# P·V tiles the f32 forward kernel sums on the tensor cores before each block
# is promoted into f32 sums (kPromoteTiles in flash_attn_fwd.cu)
FWD_PROMOTE_TILES = 8


def tf32_fwd_tile_model(q, k, v, stable, terms=3, mask=True, promote=True):
    """The f32 forward kernel's numerics and tile schedule in plain torch, one
    (batch, head) at a time: q' = q·log2(e)/√D in f32; the keys in tiles of
    FWD_F32_TILE, the rows past S zero-filled (the pre-pass's padding) and
    multiplied like any other; s = q'·kᵀ as mm_tf32 over each half of the
    head dim, the two halves added in f32; in the last tile the scores of
    columns >= S - k0 forced to -inf (``mask``); bound: m = |q'|·max|k|;
    stable: the running max per tile, with l, O and the promoted sum brought
    along as the kernel does; p = exp2(s - m) in f32, l += Σp; O += p·v as
    mm_tf32 with the keys in the kernel's order (the A columns as the
    fragments hand them over, the V rows as the pre-pass permutes its
    transposed copy); P·V summed FWD_PROMOTE_TILES tiles at a time and each
    block added into an f32 sum (``promote``).  ``terms=1``: one TF32 product.
    Returns (O, lse [B*H, S])."""
    B, S, H, D = q.shape
    T = FWD_F32_TILE
    n = -(-S // T)
    pad = n * T - S
    into_slot = {i: c.pop() for i, c in fragment_columns().items()}
    a_cols = [8 * (c // 8) + into_slot[c % 8] for c in range(T)]
    b_rows = [8 * (c // 8) + TF32_ROW_AT[c % 8] for c in range(T)]
    qs = q.float() * (LOG2E / D ** 0.5)
    kp, vp = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)) for x in (k, v))
    o = torch.empty(B, S, H, D)
    lse = torch.empty(B, H, S)
    half = D // 2
    for b in range(B):
        for h in range(H):
            qh = qs[b, :, h]
            if stable:
                m = torch.full((S,), -1e30)
            else:
                m = qh.norm(dim=-1) * k[b, :, h].float().norm(dim=-1).max()
            m_sum = m.clone()
            l, acc, total = torch.zeros(S), torch.zeros(S, D), torch.zeros(S, D)
            for t in range(n):
                kt, vt = kp[b, t * T:(t + 1) * T, h], vp[b, t * T:(t + 1) * T, h]
                sc = (mm_tf32(qh[:, :half], kt[:, :half].T, terms)
                      + mm_tf32(qh[:, half:], kt[:, half:].T, terms))
                if mask:
                    sc[:, S - t * T:] = -torch.inf
                if stable:
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    m, l, acc = m_new, l * alpha, acc * alpha[:, None]
                if promote and t > 0 and t % FWD_PROMOTE_TILES == 0:
                    total = total * torch.exp2(m_sum - m)[:, None] + acc
                    m_sum, acc = m, torch.zeros(S, D)
                p = torch.exp2(sc - m[:, None])
                l = l + p.sum(-1)
                acc = acc + mm_tf32(p[:, a_cols], vt[b_rows], terms)
            lc = l.clamp_min(1e-30)
            o[b, :, h] = (total * torch.exp2(m_sum - m)[:, None] + acc) / lc[:, None]
            lse[b, h] = m + torch.log2(lc)
    return o, lse.reshape(B * H, S)


class TestTf32ForwardModel:
    """The f32 forward kernel's 3xTF32 numerics and tile schedule, modelled on
    the CPU, are the plain forwards' function within chip_smoke's bounds; one
    TF32 product is not, nor is the model without the mask of the padded keys."""

    @pytest.mark.parametrize("stable", [False, True])
    @pytest.mark.parametrize("S", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 300])
    def test_model_matches_plain(self, S, stable):
        """Measured ~1e-6 (3xTF32 keeps ~21 bits of a product); held to
        chip_smoke.fwd_bound (F32_TOL, 5e-5) and LSE_TOL."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(300 + S, 2, S, 2))
        ref = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o_ref, lse_ref = ref(q, k, v)
        o, lse = tf32_fwd_tile_model(q, k, v, stable)
        assert (o - o_ref).abs().max().item() <= chip_smoke.fwd_bound(o_ref)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL

    def test_model_holds_the_30x_input(self):
        """The stable mode's 30x input (logits 100-200, an f32 ulp 1.5e-5):
        the model within LSE_TOL_30X and F32_REL_TOL_30X of the plain version."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(23, 1, 300, 2, scale=30.0))
        o_ref, lse_ref = flash_attention_stable_reference(q, k, v)
        o, lse = tf32_fwd_tile_model(q, k, v, stable=True)
        assert (o - o_ref).abs().max().item() <= chip_smoke.fwd_bound(o_ref, q_scale=30.0)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL_30X

    @pytest.mark.parametrize("stable", [False, True])
    def test_one_tf32_product_breaks_the_bound(self, stable):
        """hi·hi alone keeps ~11 bits of each product: O moves past F32_TOL
        several times over, so the bound tells the designs apart."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(310, 2, 300, 2))
        ref = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o_ref, _ = ref(q, k, v)
        o, _ = tf32_fwd_tile_model(q, k, v, stable, terms=1)
        assert (o - o_ref).abs().max().item() > 4 * chip_smoke.fwd_bound(o_ref)

    @pytest.mark.parametrize("stable", [False, True])
    def test_unmasked_padding_breaks_the_bounds(self, stable):
        """At S = 33 the last tile holds one key and 31 zero rows: left in,
        they move lse past LSE_TOL and O past fwd_bound."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(311, 2, 33, 2))
        ref = flash_attention_stable_reference if stable else flash_attention_bound_reference
        o_ref, lse_ref = ref(q, k, v)
        o, lse = tf32_fwd_tile_model(q, k, v, stable, mask=False)
        assert (lse - lse_ref).abs().max().item() > chip_smoke.LSE_TOL
        assert (o - o_ref).abs().max().item() > chip_smoke.fwd_bound(o_ref)

    def test_source_constants(self):
        """The constants the model assumes are the ones flash_attn_fwd.cu
        compiles: the key tile, 64 rows a warpgroup and two warpgroups a CTA,
        the promotion block, three TF32 products, the split copies' padding,
        the head dim's halves in their own score accumulators, and P's
        fragments from the shared pairing (flash_tf32.cuh)."""
        from da3slam_tpu_torch.ops import flash_attention as fa

        text = (fa._CSRC / "flash_attn_fwd.cu").read_text()
        shared = (fa._CSRC / "flash_tf32.cuh").read_text()
        assert '#include "flash_tf32.cuh"' in text
        assert f"constexpr int kF32N = {FWD_F32_TILE};" in text
        assert "constexpr int kWgRows = 64;" in text
        assert f"constexpr int kF32Consumers = {FWD_F32_ROWS // 64};" in text
        assert "constexpr int kF32Rows = kWgRows * kF32Consumers;" in text
        assert f"constexpr int kPromoteTiles = {FWD_PROMOTE_TILES};" in text
        assert "constexpr int kTf32Terms = 3;" in text
        assert f"constexpr int kTf32Pad = {TF32_PAD};" in shared
        assert "split_fragments(p, p_hi, p_lo);" in text
        for acc, steps in (("s0", "i = 0; i < 4"), ("s1", "i = 4; i < 8")):
            assert f"for (int {steps}; ++i) {{\n      wgmma_m64n32k8_tf32_ss({acc}," in text
        assert "flash_fwd_f32_kernel" not in text, "the FMA forward is gone"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


STABLE_CARD_CASES = [
    (torch.bfloat16, (3, 1301, 2, 64)),
    (torch.bfloat16, (1, 777, 6, 64)),  # ragged last q and k tile
    (torch.float32, (2, 300, 3, 64)),
    (torch.float32, (1, 63, 1, 64)),  # shorter than one tile
]
BWD_CARD_CASES = [
    (torch.float32, (2, 300, 3, 64)),
    (torch.float32, (1, 63, 1, 64)),
    (torch.float32, (4, 1301, 2, 64)),  # the training intra-view length
    (torch.bfloat16, (1, 777, 6, 64)),
    (torch.bfloat16, (4, 1301, 6, 64)),  # the bf16 step's intra-view call
    (torch.bfloat16, (1, 5204, 6, 64)),  # and its cross-view call
    (torch.float32, (1, 5204, 6, 64)),  # the f32 step's cross-view call
]


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize(
        "dtype,shape,tol",
        [
            (torch.bfloat16, (3, 1301, 2, 64), 2e-2),  # intra-view sequence length
            (torch.bfloat16, (1, 777, 6, 64), 2e-2),  # ragged last q and k tile
            (torch.float32, (2, 300, 3, 64), 5e-5),
            (torch.float32, (1, 63, 1, 64), 5e-5),  # shorter than one tile
        ],
    )
    def test_kernel_matches_plain(self, card, dtype, shape, tol):
        gen = torch.Generator(device=card).manual_seed(0)
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
        before = flash_attention_bound.launches
        o, lse = flash_attention_bound(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention_bound.launches == before + 1
        o_ref, lse_ref = flash_attention_bound_reference(q, k, v)
        assert torch.isfinite(o).all()
        assert (o.float() - o_ref.float()).abs().max().item() <= tol
        assert (lse - lse_ref).abs().max().item() <= 1e-3

    def test_kernel_underflow_gives_zeros(self, card):
        q, k, v = (torch.from_numpy(x).to(card) for x in rand_qkv(23, 1, 128, 1, scale=30.0))
        o, _ = flash_attention_bound(q, k, v)
        assert (o == 0).all()

    def test_wrapper_rejects_what_the_kernel_does_not_take(self, card):
        x = torch.zeros(1, 8, 2, 64, device=card)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention_bound(*(torch.zeros(1, 8, 2, 32, device=card),) * 3)
        with pytest.raises(ValueError, match="dtype"):
            flash_attention_bound(x.half(), x.half(), x.half())
        with pytest.raises(ValueError, match="contiguous"):
            t = torch.zeros(1, 2, 8, 64, device=card).transpose(1, 2)
            flash_attention_bound(t, t, t)
        with pytest.raises(ValueError, match="head_dim"):
            multi_head_attention(*(torch.zeros(1, 8, 1, 128, device=card),) * 3)

    @pytest.mark.parametrize("dtype,shape", STABLE_CARD_CASES)
    def test_stable_kernel_matches_plain(self, card, dtype, shape):
        gen = torch.Generator(device=card).manual_seed(1)
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
        before = flash_attention_stable.launches
        o, lse = flash_attention_stable(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention_stable.launches == before + 1
        o_ref, lse_ref = flash_attention_stable_reference(q, k, v)
        assert torch.isfinite(o).all()
        assert (o.float() - o_ref.float()).abs().max().item() <= chip_smoke.fwd_bound(o_ref)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL

    def test_stable_kernel_30x_scaled_q(self, card):
        """Where the bound kernel gives zeros, the stable one matches its plain
        version (lse 100-200: see chip_smoke.LSE_TOL_30X)."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(23, 1, 300, 2, scale=30.0), device=card)
        o, lse = flash_attention_stable(q, k, v)
        o_ref, lse_ref = flash_attention_stable_reference(q, k, v)
        assert (o - o_ref).abs().max().item() <= chip_smoke.fwd_bound(o_ref, q_scale=30.0)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL_30X
        assert (flash_attention_bound(q, k, v)[0] == 0).all()

    @pytest.mark.parametrize("dtype,shape", BWD_CARD_CASES)
    def test_backward_kernels_match_plain(self, card, dtype, shape):
        q, k, v = torch_inputs(dtype, *rand_qkv(40, *shape[:3]), device=card)
        g = torch.from_numpy(rand_grad(41, shape)).to(card)
        o, lse = flash_attention_bound(q, k, v)
        before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
        grads = flash_attention_backward(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == \
            (before[0] + 1, before[1] + 1)
        refs = flash_attention_backward_reference(q, k, v, o, lse, g)
        for name, a, r in zip("qkv", grads, refs):
            assert a.dtype == dtype and a.shape == r.shape
            assert torch.isfinite(a).all()
            err = (a.float() - r.float()).abs().max().item()
            assert err <= chip_smoke.grad_bound(r), f"d{name}: {err}"

    def test_multi_head_attention_is_differentiable_on_card(self, card):
        """The repaired fault: the kernels' outputs had no grad_fn, so q, k
        and v got no gradient on the card.  Now they do, and they match the
        plain version's (the same Function on CPU tensors)."""
        q, k, v = rand_qkv(42, 2, 300, 3)
        w = rand_grad(43, q.shape)
        grads = {}
        for dev in ("cpu", card):
            ts = [torch.from_numpy(x).to(dev).requires_grad_() for x in (q, k, v)]
            before = [f.launches for f in COUNTED]
            (multi_head_attention(*ts) * torch.from_numpy(w).to(dev)).sum().backward()
            after = [f.launches - b for f, b in zip(COUNTED, before)]
            assert after == ([0, 0, 0, 0] if dev == "cpu" else [1, 0, 1, 1])
            assert all(t.grad is not None for t in ts)
            grads[str(dev)] = [t.grad.cpu() for t in ts]
        for a, r in zip(grads["cuda"], grads["cpu"]):
            assert (a - r).abs().max().item() <= chip_smoke.grad_bound(r)

    def test_no_grad_launches_no_backward(self, card):
        q, k, v = (torch.zeros(1, 70, 2, 64, device=card, requires_grad=True) for _ in range(3))
        before = [f.launches for f in COUNTED]
        with torch.no_grad():
            out = multi_head_attention(q, k, v)
        assert out.grad_fn is None
        assert [f.launches - b for f, b in zip(COUNTED, before)] == [1, 0, 0, 0]

    @pytest.mark.parametrize("stable", [False, True])
    @pytest.mark.parametrize("H", [1, 16])
    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 1301])
    def test_bf16_tile_edges_match_plain(self, card, S, B, H, stable):
        """The tensor-core forwards around the 64-row warpgroup and the
        128-key tile, O and lse, at the smoke's bounds."""
        fwd, ref = ((flash_attention_stable, flash_attention_stable_reference) if stable
                    else (flash_attention_bound, flash_attention_bound_reference))
        q, k, v = torch_inputs(torch.bfloat16, *rand_qkv(70 + S, B, S, H), device=card)
        before = fwd.launches
        o, lse = fwd(q, k, v)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        o_ref, lse_ref = ref(q, k, v)
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        assert (o.float() - o_ref.float()).abs().max().item() <= chip_smoke.fwd_bound(o_ref)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL

    @pytest.mark.parametrize("H", [1, 16])
    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 1301])
    def test_bf16_backward_tile_edges_match_plain(self, card, S, B, H):
        """The tensor-core dq and dk/dv kernels around their 64-row warpgroups,
        128-row CTAs and 64- and 32-row ring tiles, at the smoke's bound (dq at S = 1
        is cancellation noise around 0: DQ_NOISE)."""
        q, k, v = torch_inputs(torch.bfloat16, *rand_qkv(170 + S, B, S, H), device=card)
        g = torch.from_numpy(rand_grad(171 + S, (B, S, H, 64))).to(card, torch.bfloat16)
        o, lse = flash_attention_bound(q, k, v)
        before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
        grads = flash_attention_backward(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == \
            (before[0] + 1, before[1] + 1)
        refs = flash_attention_backward_reference(q, k, v, o, lse, g)
        for name, a, r in zip("qkv", grads, refs):
            assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), f"d{name}"
            err = (a.float() - r.float()).abs().max().item()
            assert err <= max(chip_smoke.grad_bound(r), DQ_NOISE), f"d{name}: {err}"

    @pytest.mark.parametrize("S", [65, 129, 300])
    def test_bf16_backward_masks_overflowing_padding(self, card, S):
        """Every logit near -216, so a padded key's p overflows: the kernels'
        gradients stay finite and within the bound of the plain ones."""
        q, k, v, g, lse, delta = (t.to(card) for t in anti_aligned_inputs(S))
        grads = (flash_attention_bwd_dq(q, k, v, g, lse, delta),
                 *flash_attention_bwd_dkv(q, k, v, g, lse, delta))
        refs = (flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                *flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        for name, a, r in zip("qkv", grads, refs):
            assert torch.isfinite(a).all(), f"d{name}"
            err = (a.float() - r.float()).abs().max().item()
            assert err <= chip_smoke.grad_bound(r), f"d{name}: {err}"

    def test_bf16_backward_bound_catches_a_dropped_tile(self, card):
        """At a ragged S the kernels are further from the plain backward that
        lost its last key tile (dq) or q tile (dk/dv) than the bound allows."""
        q, k, v = torch_inputs(torch.bfloat16, *rand_qkv(180, 1, 1301, 2), device=card)
        g = torch.from_numpy(rand_grad(181, (1, 1301, 2, 64))).to(card, torch.bfloat16)
        o, lse = flash_attention_bound(q, k, v)
        delta = attention_delta(o, g)
        grads = flash_attention_backward(q, k, v, o, lse, g)
        cuts = chip_smoke.dropped_tile_errors(q, k, v, g, lse, delta, grads)
        for name, err, a in zip("qkv", cuts, grads):
            assert err > chip_smoke.grad_bound(a), f"d{name}: {err}"

    @pytest.mark.parametrize("H", [1, 16])
    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("S", [1, 31, 32, 33, 63, 64, 65, 129, 1301])
    def test_f32_backward_tile_edges_match_plain(self, card, S, B, H):
        """The 3xTF32 dq and dk/dv kernels around their 32-row ring tiles and
        64-row CTAs, at the smoke's f32 bound (dq at S = 1: DQ_NOISE)."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(270 + S, B, S, H), device=card)
        g = torch.from_numpy(rand_grad(271 + S, (B, S, H, 64))).to(card)
        o, lse = flash_attention_bound(q, k, v)
        before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
        grads = flash_attention_backward(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == \
            (before[0] + 1, before[1] + 1)
        refs = flash_attention_backward_reference(q, k, v, o, lse, g)
        for name, a, r in zip("qkv", grads, refs):
            assert a.dtype == torch.float32 and torch.isfinite(a).all(), f"d{name}"
            err = (a - r).abs().max().item()
            assert err <= max(chip_smoke.grad_bound(r), DQ_NOISE), f"d{name}: {err}"

    @pytest.mark.parametrize("S", [33, 65, 129, 300])
    def test_f32_backward_masks_overflowing_padding(self, card, S):
        """f32 inputs whose every logit is near -216: the kernels' gradients
        stay finite and within the bound of the plain ones."""
        q, k, v, g, lse, delta = (t.to(card) for t in
                                  anti_aligned_inputs(S, dtype=torch.float32, spread=1.0))
        grads = (flash_attention_bwd_dq(q, k, v, g, lse, delta),
                 *flash_attention_bwd_dkv(q, k, v, g, lse, delta))
        refs = (flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                *flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        for name, a, r in zip("qkv", grads, refs):
            assert torch.isfinite(a).all(), f"d{name}"
            err = (a - r).abs().max().item()
            assert err <= chip_smoke.grad_bound(r), f"d{name}: {err}"

    def test_f32_backward_bound_catches_a_dropped_tile(self, card):
        """At a ragged S the f32 kernels are further from the plain backward
        that lost its last 32-row key or q tile than the bound allows."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(280, 1, 1301, 2), device=card)
        g = torch.from_numpy(rand_grad(281, (1, 1301, 2, 64))).to(card)
        o, lse = flash_attention_bound(q, k, v)
        delta = attention_delta(o, g)
        grads = flash_attention_backward(q, k, v, o, lse, g)
        cuts = chip_smoke.dropped_tile_errors(q, k, v, g, lse, delta, grads)
        for name, err, a in zip("qkv", cuts, grads):
            assert err > chip_smoke.grad_bound(a), f"d{name}: {err}"

    @pytest.mark.parametrize("stable", [False, True])
    @pytest.mark.parametrize("H", [1, 16])
    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("S", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1301])
    def test_f32_tile_edges_match_plain(self, card, S, B, H, stable):
        """The 3xTF32 forwards around the 32-key tile, the 64-row warpgroup
        and the 128-row CTA, O and lse, at the smoke's bounds."""
        fwd, ref = ((flash_attention_stable, flash_attention_stable_reference) if stable
                    else (flash_attention_bound, flash_attention_bound_reference))
        q, k, v = torch_inputs(torch.float32, *rand_qkv(370 + S, B, S, H), device=card)
        before = fwd.launches
        o, lse = fwd(q, k, v)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        o_ref, lse_ref = ref(q, k, v)
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        assert (o - o_ref).abs().max().item() <= chip_smoke.fwd_bound(o_ref)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL

    @pytest.mark.parametrize("stable", [False, True])
    @pytest.mark.parametrize("shape", [(4, 1301, 6, 64), (1, 5204, 6, 64)])
    def test_f32_train_shapes_match_plain(self, card, shape, stable):
        """The f32 training step's intra- and cross-view calls."""
        fwd, ref = ((flash_attention_stable, flash_attention_stable_reference) if stable
                    else (flash_attention_bound, flash_attention_bound_reference))
        q, k, v = torch_inputs(torch.float32, *rand_qkv(380, *shape[:3]), device=card)
        o, lse = fwd(q, k, v)
        o_ref, lse_ref = ref(q, k, v)
        assert (o - o_ref).abs().max().item() <= chip_smoke.fwd_bound(o_ref)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL

    def test_f32_stable_30x_at_the_smoke_shape(self, card):
        """chip_smoke.STABLE_CASES's 30x input: logits 100-200 summed by the
        tensor cores, held to LSE_TOL_30X and F32_REL_TOL_30X."""
        q, k, v = torch_inputs(torch.float32, *rand_qkv(381, 1, 1301, 6, scale=30.0), device=card)
        o, lse = flash_attention_stable(q, k, v)
        o_ref, lse_ref = flash_attention_stable_reference(q, k, v)
        assert (o - o_ref).abs().max().item() <= chip_smoke.fwd_bound(o_ref, q_scale=30.0)
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL_30X

    @pytest.mark.parametrize("stable", [False, True])
    def test_f32_bounds_catch_a_dropped_last_tile(self, card, stable):
        """At a ragged S the f32 kernel is further from the plain forward
        that lost its last 32-key tile (21 keys of 1301) than the bounds allow."""
        fwd = flash_attention_stable if stable else flash_attention_bound
        q, k, v = torch_inputs(torch.float32, *rand_qkv(382, 1, 1301, 2), device=card)
        o, lse = fwd(q, k, v)
        cut = chip_smoke.dropped_key_tile_errors(q, k, v, o, lse)
        assert cut["o"] > chip_smoke.fwd_bound(o) and cut["lse"] > chip_smoke.LSE_TOL, cut

    @pytest.mark.parametrize("stable", [False, True])
    def test_bounds_catch_a_dropped_last_tile(self, card, stable):
        """At a ragged S the kernel is further from the plain version that
        lost its last key tile (21 keys of 1301) than the bounds allow: a
        kernel that skipped or mis-masked that tile would fail the case above.
        O and lse are the same quantities in either mode, so the plain bound
        forward over the first 1280 keys serves both."""
        fwd = flash_attention_stable if stable else flash_attention_bound
        q, k, v = torch_inputs(torch.bfloat16, *rand_qkv(80, 1, 1301, 2), device=card)
        o, lse = fwd(q, k, v)
        cut = 1300 // TILE_K * TILE_K
        o_cut, lse_cut = flash_attention_bound_reference(q, k[:, :cut], v[:, :cut])
        assert (o.float() - o_cut.float()).abs().max().item() > chip_smoke.fwd_bound(o_cut)
        assert (lse - lse_cut).abs().max().item() > chip_smoke.LSE_TOL


class TestStageTool:
    """tools/flash_fwd_stages.py builds the forward's source at each design
    stage and in cut-down copies; here only what needs no card."""

    def test_parts_cut_lines_that_exist_once(self):
        from da3slam_tpu_torch.ops import flash_attention as fa
        from da3slam_tpu_torch.tools import flash_fwd_stages as tool

        text = (fa._CSRC / tool.SOURCE).read_text()
        for name, cuts in tool.PARTS.items():
            for old, _ in cuts:
                assert text.count(old) == 1, (name, old)
        # the last stage is the kernel as the library builds it: the macros' defaults
        for macro, value in zip(("STAGES", "CONSUMERS", "OVERLAP"), tool.STAGES["+overlap"]):
            assert f"#define FLASH_FWD_{macro} {value} " in text

    def test_f32_variants_cut_lines_that_exist_once(self):
        """The f32 variants' replacements apply to the forward's source as it
        stands, each once, and change it (but the as-built one)."""
        from da3slam_tpu_torch.ops import flash_attention as fa
        from da3slam_tpu_torch.tools import flash_fwd_stages as tool

        text = (fa._CSRC / tool.SOURCE).read_text()
        for name, (cuts, _) in tool.F32_VARIANTS.items():
            for old, _ in cuts:
                assert text.count(old) == 1, (name, old)
            assert (tool.cut_source(cuts) == text) == (name == "f32_as_built"), name
        assert tool.F32_TOL == chip_smoke.F32_TOL and tool.LSE_TOL == chip_smoke.LSE_TOL

    def test_refuses_to_run_without_a_card(self):
        from da3slam_tpu_torch.tools import flash_fwd_stages as tool

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main([])

    def test_backward_variants_cut_lines_that_exist_once(self):
        """tools/flash_bwd_stages.py: every variant's replacements apply to the
        backward's source as it stands, and change it."""
        from da3slam_tpu_torch.ops import flash_attention as fa
        from da3slam_tpu_torch.tools import flash_bwd_stages as tool

        text = (fa._CSRC / tool.SOURCE).read_text()
        for name in tool.VARIANTS:
            if name.endswith("as_built"):
                assert tool.cut_source(name) == text, name
            else:
                assert tool.cut_source(name) != text, name
        assert f"constexpr int kPairTile = {BWD_TILE};" in text
        assert f"static constexpr int kN = kDkv ? {BWD_TILE_DKV} : {BWD_TILE};" in text
        assert f"constexpr int kF32N = {BWD_F32_TILE};" in text

    def test_backward_tool_refuses_to_run_without_a_card(self):
        from da3slam_tpu_torch.tools import flash_bwd_stages as tool

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main([])
