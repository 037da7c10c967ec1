"""The port's int8 flash forward against the JAX package's int8 probe kernel.

CPU cases: ``int8_flash_reference`` (what ``int8_flash`` runs on CPU tensors)
against ``int8_flash`` of the JAX package's ``tools/int8_flash_probe.py``,
loaded by path and run through the Pallas interpreter, on the same numpy
inputs.  The quantization before the kernel is the same IEEE arithmetic in
both (divide, multiply, round half to even), and the integer products are
exact in both, so the two differ where ``exp2`` does: a p8 at a rounding
boundary can tip by one count of 127 (of ~10^3-10^4 counts in a row's sum),
and the bf16 output by its last bit.  Tolerance: 2^-6·max|O|, as for the
other forwards (two to four bf16 ulps of the largest output), and at least
99% of the elements bit-equal.  ``TestKernelLayout`` models on the CPU what
the s8 ``wgmma`` kernel's design rests on (the permuted Vᵀ, the fragment
pairing, the exact conversions).  CUDA cases (marker ``cuda``, skipped
without a card) hold the hand-written kernel to the plain version, at
``block_k`` 64 and 192 among others (blocks of one and three 64-key tiles):

    python -m pytest --noconftest -m cuda tests/test_torch_int8_flash.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from da3slam_tpu_torch.ops.int8_flash import (
    _descale,
    effective_block_k,
    int8_attention,
    int8_attention_reference,
    int8_flash,
    int8_flash_reference,
    quantize_qkv,
    value_layout,
    values_from_layout,
)
from da3slam_tpu_torch.tools import int8_flash_probe as port_tool

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
D = 64
BF16_REL_TOL = 2.0 ** -6
SOFTMAX_REL_TOL = 0.08  # the tool's own limit on random-normal inputs


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's root ``tools/int8_flash_probe.py`` as a module, its
    kernel interpreted."""
    spec = importlib.util.spec_from_file_location("jax_tool_int8_flash_probe",
                                                  ROOT / "tools" / "int8_flash_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def inputs(seed, S, H, dtype, B=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32)).to(dtype)
            for _ in range(3)]


def jax_int8(tool, q, k, v, block_k):
    import jax.numpy as jnp

    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)]
    return np.asarray(tool.int8_flash(*args, block_q=512, block_k=block_k), np.float32)


def softmax_attention(q, k, v):
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    return (torch.softmax(qf @ kf.transpose(-1, -2) / D ** 0.5, -1) @ vf).transpose(1, 2)


def assert_close(o, o_jax):
    o = o.float().numpy()
    assert np.isfinite(o).all()
    assert np.abs(o - o_jax).max() <= BF16_REL_TOL * np.abs(o_jax).max()
    assert (o == o_jax).mean() >= 0.99


class TestMatchesJax:
    # (S, block_k, dtype): ragged and exact last blocks; block_k 512 at S = 300
    # runs at the sequence rounded up to 128 (384), as in the JAX tool
    @pytest.mark.parametrize("S,block_k,dtype", [
        (300, 128, torch.float32), (300, 512, torch.bfloat16),
        (1500, 512, torch.float32), (1500, 128, torch.bfloat16),
        (256, 128, torch.bfloat16), (1536, 512, torch.float32),
    ])
    def test_plain_version(self, jax_tool, S, block_k, dtype):
        q, k, v = inputs(S + block_k, S, 2, dtype)
        o = int8_flash(q, k, v, block_k=block_k)
        assert o.dtype == torch.bfloat16 and o.shape == q.shape
        assert_close(o, jax_int8(jax_tool, q, k, v, block_k))
        # accuracy against softmax is the algorithm's, and moves with the
        # inputs (0.04-0.25 of the output's range over these cases): it is held
        # to the tool's limit at the tool's own check case, below

    def test_quantization_equals_jax(self, jax_tool):
        """The prologue alone, on exact integers: q8, k8, v8 and the scales of
        the JAX tool's ``int8_flash`` body, recomputed with its formulas."""
        import jax.numpy as jnp

        S, bk = 300, 128
        q, k, v = inputs(3, S, 2, torch.float32)
        q8, k8, v8, sq, sk, va, bk_eff = quantize_qkv(q, k, v, bk)
        assert bk_eff == bk and k8.shape == (2, 384, D)

        def fold(x, St):
            x = jnp.swapaxes(jnp.asarray(x.numpy()), 1, 2).reshape(2, S, D)
            return jnp.pad(x, ((0, 0), (0, St - S), (0, 0)))

        qf, kf, vf = fold(q, S), fold(k, 384), fold(v, 384)
        qa = jnp.max(jnp.abs(qf), axis=-1, keepdims=True)
        jq8 = jnp.clip(jnp.round(qf / jnp.maximum(qa, 1e-30) * 127.0), -127, 127)
        jsq = (qa[..., 0] / 127.0) * (jax_tool.LOG2E / D ** 0.5)
        kb = jnp.maximum(jnp.max(jnp.max(jnp.abs(kf), axis=-1).reshape(2, 3, bk), axis=-1), 1e-30)
        jk8 = jnp.clip(jnp.round(kf / jnp.repeat(kb, bk, axis=-1)[..., None] * 127.0), -127, 127)
        jva = jnp.maximum(jnp.max(jnp.abs(vf), axis=(0, 1)), 1e-30)
        jv8 = jnp.clip(jnp.round(vf / jva * 127.0), -127, 127)
        for ours, theirs in ((q8, jq8), (k8, jk8), (v8, jv8), (sq, jsq), (sk, kb / 127.0),
                             (va, jva)):
            np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs, np.float32))
        assert (k8[:, S:] == 0).all() and (v8[:, S:] == 0).all()

    def test_padded_keys_join_the_max(self, jax_tool):
        """Every real score is negative (k = -2a + noise against q = a +
        noise) and the last block is ragged: its padded keys score exactly 0,
        which becomes the block's max, every real p8 of that block rounds to
        0, and the earlier block's sums are scaled by the same alpha in
        numerator and denominator.  So the output is attention over the first
        block alone, in the JAX kernel and in the port; a version that masked
        the padding to -inf would attend over all 200 keys."""
        S, bk = 200, 128
        rng = np.random.default_rng(11)
        a = rng.normal(size=(1, 1, 2, D))
        q = torch.from_numpy((a + 0.1 * rng.normal(size=(1, S, 2, D))).astype(np.float32))
        k = torch.from_numpy((-2 * a + 0.3 * rng.normal(size=(1, S, 2, D))).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=(1, S, 2, D)).astype(np.float32))
        o = int8_flash(q, k, v, block_k=bk)
        assert_close(o, jax_int8(jax_tool, q, k, v, bk))
        masked = softmax_attention(q, k, v)
        first_block = softmax_attention(q, k[:, :bk], v[:, :bk])
        tol = SOFTMAX_REL_TOL * first_block.abs().max()
        assert (o.float() - first_block).abs().max() < tol
        assert (o.float() - masked).abs().max() > 3 * tol

    def test_block_k_changes_the_result(self):
        q, k, v = inputs(5, 1500, 2, torch.float32)
        a, b = int8_flash(q, k, v, block_k=128), int8_flash(q, k, v, block_k=512)
        assert not torch.equal(a, b)
        # past the sequence, the block is the sequence rounded up to 128
        assert effective_block_k(300, 3584) == 384 == effective_block_k(300, 512)
        assert torch.equal(int8_flash(q[:, :300], k[:, :300], v[:, :300], block_k=3584),
                           int8_flash(q[:, :300], k[:, :300], v[:, :300], block_k=384))

    def test_a_dropped_block_breaks_the_bound(self):
        """The error bound that holds the kernel to the plain version catches
        a skipped key tile and a skipped ragged block (``drop``)."""
        q, k, v = inputs(6, 300, 2, torch.bfloat16)
        o = int8_flash_reference(q, k, v, 128)
        tol = BF16_REL_TOL * o.float().abs().max()
        for drop in ((64, 128), (256, 384)):
            cut = int8_flash_reference(q, k, v, 128, drop=drop)
            assert (cut.float() - o.float()).abs().max() > tol


class TestWrapper:
    def test_cpu_tensors_run_the_plain_version_and_count_no_launch(self):
        q, k, v = inputs(7, 130, 2, torch.float32, B=2)
        before = int8_flash.launches
        assert torch.equal(int8_flash(q, k, v, block_k=64), int8_flash_reference(q, k, v, 64))
        assert int8_flash.launches == before

    def test_bad_arguments_raise(self):
        q, k, v = inputs(8, 70, 2, torch.float32)
        with pytest.raises(ValueError, match="block_k must be a multiple of 64"):
            int8_flash(q, k, v, block_k=100)
        with pytest.raises(ValueError, match="block_k"):
            int8_flash(q, k, v, block_k=0)
        with pytest.raises(ValueError, match="equal .B, S, H, D. shapes"):
            int8_flash(q, k[:, :60], v[:, :60])

    def test_tool_runs_on_the_cpu_when_asked(self, capsys):
        rows = port_tool.main(["--S", "300", "--H", "2", "--block_k", "128", "--device", "cpu"])
        out = capsys.readouterr().out
        assert [r["tag"] for r in rows] == ["acc int8", "acc bound", "time int8", "time bound"]
        assert rows[0]["softmax_rel_err"] < SOFTMAX_REL_TOL
        assert rows[1]["softmax_rel_err"] < 1e-2  # the bound forward, bf16
        assert rows[2]["max_abs_err"] == 0.0 and rows[2]["ms"] > 0  # plain against itself
        assert out.count("TOP/s") == 2 and "max|err| vs plain" in out
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                port_tool.main(["--check"])

    def test_smoke_bound_is_the_exp2_floor(self):
        """chip_smoke.py's bound for the kernel's function: at the tool's shape
        the B·H·S² exp2 (0.673 ms) and not the int8 products (0.336 ms);
        at a small shape the bytes."""
        import chip_smoke

        r = chip_smoke.int8_roofline(1, 20816, 6, D)
        assert (r["bound_by"], r["bound_op"]) == ("operations", "exp2")
        assert r["bound_ms"] == pytest.approx(6 * 20816 ** 2 / (989e12 / 256) * 1e3)
        assert r["bound_ms"] == pytest.approx(0.67296, abs=1e-5)
        assert r["bound_ms_ops"] == pytest.approx(0.33631, abs=1e-5)
        small = chip_smoke.int8_roofline(2, 300, 3, D)
        assert small["bound_by"] == "bytes" and small["bound_ms"] > small["exp2_floor_ms"]

    def test_tool_check_case(self, capsys):
        (row,) = port_tool.main(["--check", "--device", "cpu"])
        assert (row["S"], row["H"], row["block_k"]) == (1500, 2, 512)
        assert row["softmax_rel_err"] < SOFTMAX_REL_TOL
        assert "check OK" in capsys.readouterr().out


class TestKernelLayout:
    """What the s8 ``wgmma`` kernel's design rests on, modelled on the CPU: the
    permuted Vᵀ, the pairing of score accumulators with P·V's A fragments, and
    the exact full-rate forms of its two conversions."""

    def test_value_layout_undone_gives_v8_back(self):
        rng = np.random.default_rng(12)
        v8 = torch.from_numpy(rng.integers(-127, 128, (3, 192, D)).astype(np.int8))
        vt = value_layout(v8)
        assert vt.shape == (3, D, 192) and vt.is_contiguous()
        assert torch.equal(values_from_layout(vt), v8)
        for pos in range(192):
            g, r = divmod(pos, 16)
            c, i = divmod(r, 4)
            assert torch.equal(vt[:, :, pos], v8[:, 16 * g + 2 * c + (i & 1) + 8 * (i >> 1)])

    def test_fragments_pair_scores_with_permuted_values(self):
        """One 64-key tile: each thread's s32 accumulator elements (d[4j + 2h
        + e] = S[16w + lane/4 + 8h, 8j + 2c + e]) packed into P·V's A registers
        as the kernel's ``tile_p8`` packs them, placed where the ISA's s8 A
        fragment puts them (register 4kk + r, byte i: row 16w + lane/4 +
        8(r & 1), inner index 32kk + 16(r >> 1) + 4c + i), times the permuted
        Vᵀ, is P·V."""
        rng = np.random.default_rng(13)
        P = rng.integers(0, 128, (64, 64))
        V = rng.integers(-127, 128, (64, D))
        vt = value_layout(torch.from_numpy(V[None].astype(np.int8)))[0].numpy().astype(np.int64)
        A = np.full((64, 64), -1, dtype=np.int64)
        for w in range(4):
            for lane in range(32):
                c, row = lane % 4, 16 * w + lane // 4
                d = {4 * j + 2 * h + e: P[row + 8 * h, 8 * j + 2 * c + e]
                     for j in range(8) for h in range(2) for e in range(2)}
                for kk in range(2):
                    for r in range(4):
                        h, j = r & 1, 4 * kk + 2 * (r >> 1)
                        packed = [d[4 * j + 2 * h], d[4 * j + 2 * h + 1],
                                  d[4 * j + 4 + 2 * h], d[4 * j + 4 + 2 * h + 1]]
                        for i in range(4):
                            A[row + 8 * h, 32 * kk + 16 * (r >> 1) + 4 * c + i] = packed[i]
        assert (A >= 0).all()  # every position written once per row
        np.testing.assert_array_equal(A @ vt.T, P @ V)

    @pytest.mark.parametrize("B,S,H,block_k,dtype", [
        (1, 300, 2, 128, torch.float32), (2, 700, 3, 192, torch.bfloat16),
        (1, 1, 2, 64, torch.float32),
    ])
    def test_wrapper_on_the_permuted_layout_is_the_plain_version(self, B, S, H, block_k, dtype):
        q, k, v = inputs(S + 1, S, H, dtype, B=B)
        q8, k8, v8, sq, sk, va, bk = quantize_qkv(q, k, v, block_k)
        before = int8_flash.launches
        out = int8_attention(q8, k8, value_layout(v8), sq, sk, S, bk)
        assert int8_flash.launches == before
        assert torch.equal(out, int8_attention_reference(q8, k8, v8, sq, sk, S, bk))
        assert torch.equal(_descale(out, va, q.shape), int8_flash_reference(q, k, v, block_k))

    def test_exact_int_to_float_over_the_score_range(self):
        """float(s) = as_float(s + 0x4B400000) − 12582912 for every score an
        int8 dot of 64 can give (|s| ≤ 127²·64 < 2^22)."""
        top = 127 * 127 * D
        assert top < 2 ** 22
        s = np.arange(-top, top + 1, dtype=np.int32)
        f = (s + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
        np.testing.assert_array_equal(f, s.astype(np.float32))

    def test_exact_truncation_of_p(self):
        """trunc(x) is the low byte of round_toward_zero(x + 2^23) for x in
        [0.5, 127.5]: every float within 64 ulps of each integer and each
        half, and 10^5 random ones (round toward zero emulated from the exact
        sum in f64)."""
        rng = np.random.default_rng(14)
        base = np.concatenate([np.arange(0, 128, 0.5, dtype=np.float32),
                               rng.uniform(0.5, 127.5, 100_000).astype(np.float32)])
        xs = [base]
        for _ in range(64):
            xs.append(np.nextafter(xs[-1], np.float32(np.inf)))
        down = [base]
        for _ in range(64):
            down.append(np.nextafter(down[-1], np.float32(0)))
        x = np.concatenate(xs + down)
        x = x[(x >= 0.5) & (x <= 127.5)]
        exact = x.astype(np.float64) + 2.0 ** 23
        rn = exact.astype(np.float32)
        rz = np.where(rn.astype(np.float64) > exact, np.nextafter(rn, np.float32(0)), rn)
        np.testing.assert_array_equal(rz.view(np.int32) & 0xFF, np.trunc(x).astype(np.int32))


class TestStageTool:
    """tools/int8_flash_stages.py builds copies of the kernel's source with
    ``-D`` defines; here only what needs no card."""

    def test_variants_set_macros_the_source_tests(self):
        from da3slam_tpu_torch.ops import flash_attention as fa
        from da3slam_tpu_torch.tools import int8_flash_stages as tool

        text = (fa._CSRC / tool.SOURCE).read_text()
        assert tool.VARIANTS["as_built"] == ()
        for name, defines in tool.VARIANTS.items():
            for define in defines:
                macro = define.split("=")[0]
                forms = ("#ifdef ", "#ifndef ", "defined(")
                assert any(f"{form}{macro}" in text for form in forms), (name, macro)
        # the library's build sets none of them: a macro with a value has a
        # default under its own #ifndef
        lines = text.splitlines()
        defaults = {}
        for i, ln in enumerate(lines):
            if ln.startswith("#define INT8_FLASH_"):
                name, value = ln.split()[1:3]
                assert lines[i - 1] == f"#ifndef {name}"
                defaults[name] = value
        assert defaults == {"INT8_FLASH_CONSUMERS": "3", "INT8_FLASH_RING_BYTES": "131072"}
        assert set(tool.EXACT) <= set(tool.VARIANTS)

    def test_refuses_to_run_without_a_card(self):
        from da3slam_tpu_torch.tools import int8_flash_stages as tool

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main([])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    # block_k 64 and 192: tiles that must not straddle a block; S = 1, 65,
    # 129 around the kernel's 64-row warpgroups and 64-key tiles; B·H > 1
    # with a ragged last block
    @pytest.mark.parametrize("B,S,H,block_k,dtype", [
        (1, 1500, 2, 512, torch.float32), (2, 300, 3, 128, torch.bfloat16),
        (1, 63, 2, 64, torch.float32), (1, 1536, 2, 512, torch.bfloat16),
        (1, 1000, 2, 64, torch.bfloat16), (2, 700, 3, 192, torch.float32),
        (1, 1, 2, 64, torch.bfloat16), (1, 65, 2, 512, torch.float32),
        (1, 129, 2, 512, torch.bfloat16), (3, 1000, 2, 384, torch.bfloat16),
    ])
    def test_kernel_matches_plain(self, card, B, S, H, block_k, dtype):
        q, k, v = (t.to(card) for t in inputs(S, S, H, dtype, B=B))
        before = int8_flash.launches
        o = int8_flash(q, k, v, block_k=block_k)
        torch.cuda.synchronize()
        assert int8_flash.launches == before + 1
        ref = int8_flash_reference(q, k, v, block_k)
        tol = BF16_REL_TOL * ref.float().abs().max().item()
        assert torch.isfinite(o).all()
        assert (o.float() - ref.float()).abs().max().item() <= tol
        assert (o == ref).float().mean().item() >= 0.99
        bk = effective_block_k(S, block_k)
        last = (-(-S // bk) - 1) * bk
        cut = int8_flash_reference(q, k, v, block_k, drop=(last, last + bk))
        assert (cut.float() - ref.float()).abs().max().item() > tol

    def test_quantized_entry_launches_once(self, card):
        q, k, v = (t.to(card) for t in inputs(10, 700, 3, torch.bfloat16, B=2))
        q8, k8, v8, sq, sk, va, bk = quantize_qkv(q, k, v, 192)
        before = int8_flash.launches
        out = int8_attention(q8, k8, value_layout(v8), sq, sk, 700, bk)
        torch.cuda.synchronize()
        assert int8_flash.launches == before + 1
        ref = int8_attention_reference(q8, k8, v8, sq, sk, 700, bk)
        assert (out.float() - ref.float()).abs().max().item() <= \
            BF16_REL_TOL * ref.float().abs().max().item()
        with pytest.raises(ValueError, match="do not fit"):
            int8_attention(q8, k8, v8, sq, sk, 700, bk)

    def test_refuses_what_the_kernel_does_not_take(self, card):
        q, k, v = (t.to(card) for t in inputs(9, 64, 2, torch.float32))
        with pytest.raises(ValueError, match="share bf16 or f32"):
            int8_flash(q.half(), k.half(), v.half())
        with pytest.raises(ValueError, match="one CUDA device"):
            int8_flash(q, k.cpu(), v)
        with pytest.raises(ValueError, match="head_dim"):
            int8_flash(q[..., :32], k[..., :32], v[..., :32])
