"""The port's loop closure against ``da3slam_tpu``: SO(3)/Sim(3) helpers,
the LM pose graph, loop detection and gating, the live solver with
``Loop.enable`` and the ported ``evaluate_trajectory``.

Both packages get the same numpy inputs (made from seeds), f32 on the CPU.
Tolerances: 1e-6 for closed-form transforms; 1e-5 for the dense pose-graph
solve (the same LM sequence, LU solves of a 35x35 system in two libraries);
1e-4 for CG (iterative sums in another order); 1e-4 of the scene extent for
the live solver's trajectory (measured 3e-6 over 48 frames and three
re-anchorings)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from da3slam_tpu.core import transforms as jt
from da3slam_tpu.ops import posegraph as jpg
from da3slam_tpu.slam import evaluate as jev
from da3slam_tpu.slam import loop as jloop
from da3slam_tpu.slam.solver import SLAMSolver as JSolver
from da3slam_tpu.utils import synthetic as jsyn
from da3slam_tpu_torch.core import transforms as tt
from da3slam_tpu_torch.ops import posegraph as tpg
from da3slam_tpu_torch.slam import evaluate as tev
from da3slam_tpu_torch.slam import loop as tloop
from da3slam_tpu_torch.slam.online_loop import OnlineLoopCloser
from da3slam_tpu_torch.slam.solver import SLAMSolver
from da3slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def J(x):
    return jnp.asarray(np.array(x, np.float32))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


# ---------------------------------------------------------------------------
# SO(3) / Sim(3)
# ---------------------------------------------------------------------------

def rotvecs(scale, n=16, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


class TestTransforms:
    # near 0 (the first-order branch of exp and the θ ≲ 4.5e-4 branch of
    # log), general angles, near π and beyond π (log returns the principal
    # rotation)
    @pytest.mark.parametrize("scale", [1e-8, 1e-5, 1e-3, 0.3, 1.0, 2.5])
    def test_so3_exp_log_match_jax(self, scale):
        w = rotvecs(scale)
        close(tt.so3_exp(T(w)).numpy(), jt.so3_exp(J(w)), 1e-6)
        R = np.asarray(jt.so3_exp(J(w)))
        close(tt.so3_log(T(R)).numpy(), jt.so3_log(J(R)), 2e-6)

    @pytest.mark.parametrize("angle", [np.pi - 1e-3, np.pi - 1e-2, np.pi - 0.1, 4.0, 6.0])
    def test_so3_log_near_and_beyond_pi(self, angle):
        """Beyond π the log returns the principal rotation.  Within ~1e-2 of
        π the formula is ill-conditioned in f32 in both packages (θ from
        arccos near -1, divided by 2 sin θ): at π - 1e-3 both return a
        vector of norm 4.55 whose exp misses R by 0.93; the port matches the
        JAX package there bit for bit rather than repairing it."""
        axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
        w = (axis * angle).astype(np.float32)
        R = tt.so3_exp(T(w))
        w2 = tt.so3_log(R)
        close(w2.numpy(), jt.so3_log(J(R.numpy())), 1e-6)
        if abs(angle - np.pi) >= 0.1:
            assert float(torch.linalg.vector_norm(w2)) <= np.pi + 1e-5
            close(tt.so3_exp(w2).numpy(), R.numpy(), 1e-4)

    def test_tests_beyond_pi_case(self):
        """tests/test_streaming.py's rotation vector of norm > π."""
        w = T([-6.975, -0.656, -3.738])
        w2 = tt.so3_log(tt.so3_exp(w))
        close(tt.so3_exp(w2).numpy(), tt.so3_exp(w).numpy(), 1e-5)
        assert float(torch.linalg.vector_norm(w2)) <= np.pi + 1e-5

    @pytest.mark.parametrize("transform", ["jacfwd", "jacrev"])
    def test_so3_log_derivative_finite_at_identity(self, transform):
        """The double ``where``: the discarded arccos branch's -inf
        derivative must not turn into 0 · inf = NaN in either mode."""
        fn = getattr(torch.func, transform)(tt.so3_log)
        for R in (torch.eye(3), tt.so3_exp(T([1e-6, 0, 0]))):
            jac = fn(R)
            assert torch.isfinite(jac).all()
            # d log / d R at the identity: the vee map's coefficients (±1/2)
            assert jac.abs().max() == pytest.approx(0.5, abs=1e-3)

    def test_sim3_helpers_match_jax(self):
        rng = np.random.default_rng(1)
        K = 5
        s = np.exp(rng.normal(size=K) * 0.2).astype(np.float32)
        R = np.asarray(jt.so3_exp(J(rotvecs(0.4, K, 2))))
        t = rng.normal(size=(K, 3)).astype(np.float32)
        pts = rng.normal(size=(K, 7, 3)).astype(np.float32)
        E = np.concatenate([R[::-1], rng.normal(size=(K, 3, 1))], -1).astype(np.float32)
        Tt, Tj = tt.Sim3(T(s), T(R), T(t)), jt.Sim3(J(s), J(R), J(t))
        close(tt.sim3_apply(Tt, T(pts)).numpy(), jt.sim3_apply(Tj, J(pts)), 1e-6)
        one_t, one_j = tt.Sim3(T(s[0]), T(R[0]), T(t[0])), jt.Sim3(J(s[0]), J(R[0]), J(t[0]))
        close(tt.sim3_apply(one_t, T(pts[0])).numpy(), jt.sim3_apply(one_j, J(pts[0])), 1e-6)
        close(tt.sim3_to_matrix(Tt).numpy(), jt.sim3_to_matrix(Tj), 1e-6)
        close(tt.sim3_transform_w2c(T(E), Tt).numpy(), jt.sim3_transform_w2c(J(E), Tj), 1e-5)
        for a, b in zip(tt.sim3_identity(), jt.sim3_identity()):
            close(a.numpy(), b, 0)

    @pytest.mark.parametrize("K", [0, 1, 6])
    def test_sim3_accumulate_matches_jax(self, K):
        """A sequential prefix product against the JAX package's
        associative scan: the same products composed in another order,
        equal to 1e-6 (f32 rounding of up to K compositions)."""
        rng = np.random.default_rng(K)
        s = np.exp(rng.normal(size=K) * 0.2).astype(np.float32)
        R = np.asarray(jt.so3_exp(J(rotvecs(0.4, K, 3)))).reshape(K, 3, 3)
        t = rng.normal(size=(K, 3)).astype(np.float32)
        out = tt.sim3_accumulate(tt.Sim3(T(s), T(R), T(t)))
        ref = jt.sim3_accumulate(jt.Sim3(J(s), J(R), J(t)))
        assert out.s.shape == (K + 1,)
        for a, b in zip(out, ref):
            close(a.numpy(), b, 1e-6)


# ---------------------------------------------------------------------------
# Pose graph: tests/test_streaming.py's cases, each also held to the JAX solver
# ---------------------------------------------------------------------------

def random_sim3(rng, s_spread=0.2, t_spread=0.5):
    w = rng.normal(size=3) * 0.3
    return (np.float32(np.exp(rng.normal() * s_spread)),
            np.asarray(jt.so3_exp(J(w))),
            (rng.normal(size=3) * t_spread).astype(np.float32))


def jsim(x):
    return jt.Sim3(*(J(a) for a in x))


def tsim(x):
    return tt.Sim3(*(T(a) for a in x))


def np_sim(S):
    return tuple(np.asarray(a) for a in S)


def compose(a, b):
    return np_sim(jt.sim3_compose(jsim(a), jsim(b)))


def inverse(a):
    return np_sim(jt.sim3_inverse(jsim(a)))


def perturb(T_, rng, eps):
    dw = J(rng.normal(size=3) * eps)
    return (np.float32(T_[0] * np.exp(rng.normal() * eps)),
            np.asarray(jt.so3_exp(dw) @ J(T_[1])),
            (T_[2] + rng.normal(size=3) * eps).astype(np.float32))


def make_chain(K, rng):
    """Ground-truth nodes (chunk k → world) and exact sequential
    measurements M_k = S_k^{-1} ∘ S_{k+1}."""
    nodes = [(np.float32(1.0), np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    for _ in range(K - 1):
        nodes.append(compose(nodes[-1], random_sim3(rng)))
    return nodes, [compose(inverse(nodes[k]), nodes[k + 1]) for k in range(K - 1)]


def drifted(nodes, meas, rng, eps):
    noisy = [perturb(M, rng, eps) for M in meas]
    init = [nodes[0]]
    for M in noisy:
        init.append(compose(init[-1], M))
    return noisy, init


def stacked(pkg, xs):
    if pkg is jt:
        return jt.Sim3(*(jnp.stack([J(x[i]) for x in xs]) for i in range(3)))
    return tt.Sim3(*(torch.stack([T(x[i]) for x in xs]) for i in range(3)))


def both_graphs(init, meas, loops, weight, **kw):
    """The same graph optimised by both packages: (port, JAX) as numpy."""
    je = jpg.add_loop_edges(jpg.sequential_edges([jsim(m) for m in meas]),
                            [(a, b, jsim(M)) for a, b, M in loops], weight=weight)
    te = tpg.add_loop_edges(tpg.sequential_edges([tsim(m) for m in meas]),
                            [(a, b, tsim(M)) for a, b, M in loops], weight=weight)
    j = jpg.optimize_sim3_pose_graph(stacked(jt, init), je, **kw)
    t = tpg.optimize_sim3_pose_graph(stacked(tt, init), te, **kw)
    return tuple(a.numpy() for a in t), np_sim(j)


class TestPoseGraph:
    def test_edges_match_jax(self):
        rng = np.random.default_rng(0)
        nodes, meas = make_chain(4, rng)
        loop = [(0, 3, compose(inverse(nodes[0]), nodes[3]))]
        je = jpg.add_loop_edges(jpg.sequential_edges([jsim(m) for m in meas]),
                                [(a, b, jsim(M)) for a, b, M in loop], weight=0.5)
        te = tpg.add_loop_edges(tpg.sequential_edges([tsim(m) for m in meas]),
                                [(a, b, tsim(M)) for a, b, M in loop], weight=0.5)
        for a, b in zip((te.i, te.j, te.weight, *te.measurement),
                        (je.i, je.j, je.weight, *je.measurement)):
            close(a.numpy(), b, 0)
        assert tpg.add_loop_edges(te, []) is te

    @pytest.mark.parametrize("solver", ["dense", "cg"])
    def test_exact_edges_zero_residual_preserved(self, solver):
        rng = np.random.default_rng(1)
        nodes, meas = make_chain(5, rng)
        out, ref = both_graphs(nodes, meas, [], 1.0, max_iterations=5, solver=solver)
        for k in range(5):
            np.testing.assert_allclose(out[0][k], nodes[k][0], rtol=1e-4)
            np.testing.assert_allclose(out[2][k], nodes[k][2], atol=1e-3)
        for a, b in zip(out, ref):
            close(a, b, 1e-5)

    @pytest.mark.parametrize("solver,tol", [("dense", 1e-5), ("cg", 1e-4)])
    def test_loop_edge_corrects_drift(self, solver, tol):
        """Noisy odometry + one exact loop edge: the last node is pulled back
        toward the ground truth, node 0 stays fixed, and the port lands
        where the JAX package does."""
        rng = np.random.default_rng(2)
        K = 6
        nodes, meas = make_chain(K, rng)
        noisy, init = drifted(nodes, meas, rng, 0.03)
        loop = [(0, K - 1, compose(inverse(nodes[0]), nodes[K - 1]))]
        out, ref = both_graphs(init, noisy, loop, 3.0, max_iterations=30, solver=solver)
        drift_before = np.linalg.norm(init[-1][2] - nodes[-1][2])
        assert np.linalg.norm(out[2][-1] - nodes[-1][2]) < 0.3 * drift_before
        np.testing.assert_allclose(out[0][0], 1.0, atol=1e-6)
        for a, b in zip(out, ref):
            close(a, b, tol)

    def test_cg_solver_matches_dense(self):
        """The matrix-free CG path lands on the dense path's optimum (the
        drift test above holds each to the JAX package)."""
        rng = np.random.default_rng(2)
        K = 6
        nodes, meas = make_chain(K, rng)
        noisy, init = drifted(nodes, meas, rng, 0.03)
        edges = tpg.add_loop_edges(tpg.sequential_edges([tsim(m) for m in noisy]),
                                   [(0, K - 1, tsim(compose(inverse(nodes[0]), nodes[K - 1])))],
                                   weight=3.0)
        dense, cg = (tpg.optimize_sim3_pose_graph(stacked(tt, init), edges, max_iterations=30,
                                                  solver=solver) for solver in ("dense", "cg"))
        close(cg.t.numpy(), dense.t.numpy(), 2e-3)
        np.testing.assert_allclose(cg.s.numpy(), dense.s.numpy(), rtol=2e-3)

    @pytest.mark.parametrize("solver", ["dense", "cg"])
    def test_false_loop_edge_bounded_by_huber(self, solver):
        """One grossly wrong loop edge (it claims the last chunk sits at
        chunk 0) must not corrupt the trajectory under the robust kernel and
        the reduced loop weight."""
        rng = np.random.default_rng(7)
        K = 8
        nodes, meas = make_chain(K, rng)
        noisy, init = drifted(nodes, meas, rng, 0.01)
        false = (np.float32(1.0), np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        out, ref = both_graphs(init, noisy, [(0, K - 1, false)], 0.5, max_iterations=30,
                               huber_delta=0.1, solver=solver)
        err = max(np.linalg.norm(out[2][k] - nodes[k][2]) for k in range(K))
        extent = max(np.linalg.norm(nodes[k][2]) for k in range(K))
        assert err < 0.15 * max(extent, 1.0)
        for a, b in zip(out, ref):
            close(a, b, 1e-5 if solver == "dense" else 1e-4)

    def test_false_loop_catastrophic_without_huber(self):
        """The scenario above is adversarial: plain least squares lets the
        false edge drag the last node far from the truth.  The port is held
        to the JAX solve at 1e-3 here: the contradictory edge leaves a cost
        flat along the compromise, where two f32 LU solves settle 7e-5
        apart."""
        rng = np.random.default_rng(7)
        K = 8
        nodes, meas = make_chain(K, rng)
        noisy, init = drifted(nodes, meas, rng, 0.01)
        false = (np.float32(1.0), np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        out, ref = both_graphs(init, noisy, [(0, K - 1, false)], 1.0, max_iterations=30,
                               huber_delta=None)
        assert np.linalg.norm(out[2][K - 1] - nodes[K - 1][2]) > 0.2 * np.linalg.norm(
            nodes[K - 1][2] - nodes[0][2])
        for a, b in zip(out, ref):
            close(a, b, 1e-3)

    def test_rejects_unknown_solver(self):
        rng = np.random.default_rng(0)
        nodes, meas = make_chain(3, rng)
        with pytest.raises(ValueError, match="solver"):
            tpg.optimize_sim3_pose_graph(stacked(tt, nodes),
                                         tpg.sequential_edges([tsim(m) for m in meas]),
                                         solver="qr")


# ---------------------------------------------------------------------------
# Loop detection and the joint-prediction constraint
# ---------------------------------------------------------------------------

def both_detectors(frames=None, descs=None, **kw):
    t, j = tloop.LoopDetector(device="cpu", **kw), jloop.LoopDetector(**kw)
    items = frames if frames is not None else descs
    for x in items:
        for det in (t, j):
            if frames is not None:
                det.add_frame(x)
            else:
                det.add_frame(None, desc=x)
    return t, j


def same_pairs(t, j):
    tp, jp = t.detect(), j.detect()
    assert [(p.frame_a, p.frame_b) for p in tp] == [(p.frame_a, p.frame_b) for p in jp]
    np.testing.assert_allclose([p.similarity for p in tp], [p.similarity for p in jp], atol=1e-6)
    return tp


class TestLoopDetector:
    @staticmethod
    def image(seed):
        return np.random.default_rng(seed).integers(0, 255, size=(48, 64, 3)).astype(np.uint8)

    def test_thumbnail_revisit_matches_jax(self):
        rng = np.random.default_rng(3)
        frames = [self.image(i) for i in range(40)]
        for i in range(5):
            noisy = np.clip(self.image(i).astype(int) + rng.integers(-5, 5, (48, 64, 3)), 0, 255)
            frames.append(noisy.astype(np.uint8))
        pairs = same_pairs(*both_detectors(frames, threshold=0.9, min_gap=10))
        assert any(p.frame_a < 5 and p.frame_b >= 40 for p in pairs)
        assert all(p.frame_b - p.frame_a >= 10 for p in pairs)

    def test_no_false_loops_on_distinct_frames(self):
        t, j = both_detectors([self.image(1000 + i) for i in range(30)], threshold=0.9,
                              min_gap=5)
        assert same_pairs(t, j) == []

    def test_descriptor_matches_jax(self):
        img = self.image(0)
        close(tloop.frame_descriptor(img), jloop.frame_descriptor(img), 0)

    def test_learned_descriptors_centred_match_jax(self):
        """Learned descriptors with a large common component (all raw
        cosines ≈ 1): both packages batch-centre and find only the planted
        revisits."""
        rng = np.random.default_rng(0)
        common = rng.normal(size=64).astype(np.float32) * 10.0
        distinct = rng.normal(size=(45, 64)).astype(np.float32)
        distinct[40:43] = distinct[0:3] + 0.01 * rng.normal(size=(3, 64))
        pairs = same_pairs(*both_detectors(descs=common[None] + distinct, threshold=0.9,
                                           min_gap=10))
        assert pairs and all(p.frame_a < 3 and p.frame_b >= 40 for p in pairs)

    def test_blocked_retrieval_matches_dense(self):
        rng = np.random.default_rng(1)
        descs = rng.normal(size=(50, 16)).astype(np.float32)
        descs[45] = descs[2] + 0.001 * rng.normal(size=16)
        a, _ = both_detectors(descs=descs, threshold=0.9, min_gap=10, block_rows=7)
        b, _ = both_detectors(descs=descs, threshold=0.9, min_gap=10, block_rows=4096)
        assert a.detect() == b.detect() and a.detect()

    def test_mixed_kinds_and_placeholders(self):
        det = tloop.LoopDetector(device="cpu")
        det.add_frame(None, desc=np.ones(8, np.float32))
        assert det.kind == "learned" and det.dim == 8
        with pytest.raises(ValueError, match="mixed descriptor kinds"):
            det.add_frame(self.image(0))
        zeros = tloop.LoopDetector(threshold=0.5, min_gap=2, device="cpu")
        for _ in range(6):
            zeros.add_frame(None, desc=np.zeros(8, np.float32))
        assert zeros.detect() == []


def terrain_chunk(depth, K):
    n = depth.shape[0]
    return {"depth": depth, "conf": np.ones(depth.shape, np.float32),
            "extrinsics": np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1)),
            "intrinsics": np.tile(K, (n, 1, 1))}


class TestLoopConstraint:
    H = W = 32
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)

    def both(self, a, b, joint_depth):
        class Joint:
            depth = joint_depth
            conf = np.ones(joint_depth.shape, np.float32)
            extrinsics = np.tile(np.eye(3, 4, dtype=np.float32), (len(joint_depth), 1, 1))
            intrinsics = np.tile(self.K, (len(joint_depth), 1, 1))

        ca, cb = terrain_chunk(a, self.K), terrain_chunk(b, self.K)
        lt = tloop.loop_sim3_from_joint_prediction(ca, cb, Joint, device="cpu")
        lj = jloop.loop_sim3_from_joint_prediction(ca, cb, Joint)
        for x, y in zip(lt.transform, lj.transform):
            close(x.numpy(), y, 1e-5)
        np.testing.assert_allclose([lt.rmse, lt.reciprocal_err], [lj.rmse, lj.reciprocal_err],
                                   atol=1e-5)
        assert lt.n_effective == lj.n_effective
        assert tloop.gate_loop_constraint(lt) == jloop.gate_loop_constraint(lj)
        return lt

    def test_gate_rejects_geometric_mismatch(self):
        rng = np.random.default_rng(11)
        plane = np.full((2, self.H, self.W), 2.0, np.float32)
        rough = (2.0 + rng.uniform(-0.9, 0.9, size=(2, self.H, self.W))).astype(np.float32)
        assert not tloop.gate_loop_constraint(self.both(plane, rough,
                                                        np.concatenate([plane, plane])))

    def test_gate_accepts_consistent_geometry(self):
        rng = np.random.default_rng(13)
        terrain = (2.0 + rng.uniform(-0.5, 0.5, size=(2, self.H, self.W))).astype(np.float32)
        assert tloop.gate_loop_constraint(self.both(terrain, terrain,
                                                    np.concatenate([terrain, terrain])))

    def test_synthetic_chunks_match_jax(self):
        """Two chunks of the out-and-back loop that see the same walls (the
        start and the return), each at its own chunk scale, registered
        through the joint prediction of the synthetic model."""
        poses = tsyn.make_loop_trajectory(48)
        idx_a, idx_b = list(range(0, 6)), list(range(42, 48))
        paths = [f"{i:06d}.jpg" for i in idx_a + idx_b]
        chunk = {}
        for name, idx, scale in (("a", idx_a, 0.8), ("b", idx_b, 1.7)):
            p = tsyn.SyntheticDA3(poses, chunk_scales=[scale], textured=True).inference(
                [f"{i:06d}.jpg" for i in idx])
            chunk[name] = {"depth": p.depth, "conf": p.conf - 1.0, "extrinsics": p.extrinsics,
                           "intrinsics": p.intrinsics}
        joint = tsyn.SyntheticDA3(poses, textured=True).inference(paths)
        joint.conf = joint.conf - 1.0
        lt = tloop.loop_sim3_from_joint_prediction(chunk["a"], chunk["b"], joint, device="cpu")
        lj = jloop.loop_sim3_from_joint_prediction(chunk["a"], chunk["b"], joint)
        for x, y in zip(lt.transform, lj.transform):
            close(x.numpy(), y, 1e-5)
        np.testing.assert_allclose(float(lt.transform.s), 0.8 / 1.7, rtol=1e-3)  # b → a
        assert tloop.gate_loop_constraint(lt) and jloop.gate_loop_constraint(lj)
        assert lt.n_effective == lj.n_effective


# ---------------------------------------------------------------------------
# Trajectory evaluation
# ---------------------------------------------------------------------------

class TestEvaluate:
    @pytest.mark.parametrize("align", ["sim3", "se3", "none"])
    def test_evaluate_trajectory_matches_jax(self, align):
        rng = np.random.default_rng(0)
        gt = gt_c2w(jsyn.make_loop_trajectory(20))
        est = gt.copy()
        est[:, :3, 3] = 1.3 * est[:, :3, 3] + rng.normal(size=(20, 3)) * 0.01
        a = tev.evaluate_trajectory(est, gt, align=align, rpe_delta=2, device="cpu")
        b = jev.evaluate_trajectory(est, gt, align=align, rpe_delta=2)
        np.testing.assert_allclose(np.array(a), np.array(b), rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError, match="shapes differ"):
            tev.evaluate_trajectory(est[:3], gt, device="cpu")

    @pytest.mark.parametrize("align", ["median", "none"])
    def test_evaluate_depth_matches_jax(self, align):
        rng = np.random.default_rng(1)
        gt = rng.uniform(0.5, 5.0, size=(3, 8, 9))
        pred = gt * 1.7 * (1 + rng.normal(size=gt.shape) * 0.05)
        mask = rng.uniform(size=gt.shape) > 0.2
        a = tev.evaluate_depth(pred, gt, mask=mask, align=align, max_depth=4.5)
        b = jev.evaluate_depth(pred, gt, mask=mask, align=align, max_depth=4.5)
        assert a == b
        with pytest.raises(ValueError, match="align"):
            tev.evaluate_depth(pred, gt, align="mean")


# ---------------------------------------------------------------------------
# The live solver with Loop.enable (tests/test_online_loop.py's setup)
# ---------------------------------------------------------------------------

N_FRAMES = 48
HW = (48, 64)


def gt_c2w(poses_w2c):
    return np.stack([np.linalg.inv(np.vstack([E, [0, 0, 0, 1]])) for E in poses_w2c])


def loop_model(pkg):
    """A fresh model a run (its call count drives the per-chunk scales)."""
    rng = np.random.default_rng(3)
    poses = pkg.make_loop_trajectory(N_FRAMES)
    return pkg.SyntheticDA3(poses, hw=HW, chunk_scales=rng.uniform(0.5, 2.0, size=24),
                            depth_noise=6e-3, textured=True, seed=7)


def loop_config(enable: bool, device_resident: bool = False) -> dict:
    return {
        "Model": {"chunk_size": 6, "overlap_size": 1, "keyframe_interval": 1,
                  "sleep_between_chunk": 0, "device_resident": device_resident},
        "Loop": {
            "enable": enable,
            "stride": 2,  # 48x64 frames: keep enough points for the gate
            "Retrieval": {"threshold": 0.9, "min_gap": 25, "max_loops": 5},
            "Gate": {"max_rmse": 0.08, "min_n_effective": 200, "max_reciprocal_err": 0.15},
            "SIM3_Optimizer": {"max_iterations": 30, "lambda_init": 1e-6},
        },
    }


class TestLiveSolver:
    def test_gating_by_config(self, tmp_path):
        image_dir = jsyn.make_synthetic_image_dir(tmp_path, 4)
        off = SLAMSolver(image_dir, {"Model": {"chunk_size": 4}}, model=loop_model(tsyn),
                         device="cpu")
        assert off.loop_closer is None
        on = SLAMSolver(image_dir, loop_config(True), model=loop_model(tsyn), device="cpu")
        assert isinstance(on.loop_closer, OnlineLoopCloser)
        assert on.loop_closer.device == torch.device("cpu")
        assert on.loop_closer.detector.device == torch.device("cpu")

    def test_loop_closure_matches_jax_and_lowers_ate(self, tmp_path):
        """48 frames out and back in chunks of 6 with per-chunk scale
        ambiguity, closure off and on, in both packages: the same accepted
        loop edges, trajectories within 1e-4 of the scene extent, and the
        closure lowers ATE (scored by the ported evaluate_trajectory, itself
        held to the JAX one on these trajectories).  The device-resident run
        (one packed fetch a chunk) gives the host path's trajectory."""
        image_dir = jsyn.make_synthetic_image_dir(tmp_path, N_FRAMES)
        gt = gt_c2w(jsyn.make_loop_trajectory(N_FRAMES))
        extent = np.abs(gt[:, :3, 3]).max()
        ate = {}
        for enable in (False, True):
            j = JSolver(image_dir, loop_config(enable), model=loop_model(jsyn), viewer=None)
            j.run()
            t = SLAMSolver(image_dir, loop_config(enable), model=loop_model(tsyn), device="cpu")
            t.run()
            c2w, c2w_jax = t.trajectory()[0], j.trajectory()[0]
            assert c2w.shape == (N_FRAMES, 4, 4)
            np.testing.assert_allclose(c2w, c2w_jax, atol=1e-4 * extent)
            res = tev.evaluate_trajectory(c2w, gt, align="sim3", device="cpu")
            ref = jev.evaluate_trajectory(c2w_jax, gt, align="sim3")
            np.testing.assert_allclose(res.ate_rmse, ref.ate_rmse, rtol=1e-3)
            ate[enable] = res.ate_rmse
            if enable:
                edges = [(a, b) for a, b, _ in t.loop_closer.loop_edges]
                assert edges == [(a, b) for a, b, _ in j.loop_closer.loop_edges]
                assert edges and all(b - a >= 2 for a, b in edges)
                assert len(t.loop_closer.attempts) >= len(edges)
                resident = SLAMSolver(image_dir, loop_config(True, device_resident=True),
                                      model=loop_model(tsyn), device="cpu")
                resident.run()
                np.testing.assert_allclose(resident.trajectory()[0], c2w, atol=1e-6)
            else:
                assert t.loop_closer is None
        assert ate[True] < ate[False]


class TestReanchorMath:
    def test_known_drift_corrected_exactly(self):
        """tests/test_online_loop.py's oracle: three chunks with exact local
        poses, the last chunk's global poses corrupted by a known rigid
        drift; one exact, trusted loop edge restores them.  The port's
        update is also held to the JAX closer's on the same inputs."""
        from da3slam_tpu.slam.online_loop import OnlineLoopCloser as JCloser

        rng = np.random.default_rng(0)

        def rand_se3(scale=0.3):
            R = np.asarray(jt.so3_exp(J(rng.normal(size=3) * scale)))
            return np.concatenate([R, rng.normal(size=(3, 1)) * scale], -1).astype(np.float32)

        E_gt = np.stack([rand_se3() for _ in range(6)]).reshape(3, 2, 3, 4)
        nodes_gt = [np.eye(4, dtype=np.float32)[:3]] + [rand_se3() for _ in range(2)]
        E_local = np.stack([np.asarray(jt.se3_compose(J(E_gt[k]), J(nodes_gt[k])[None]))
                            for k in range(3)])
        drift = rand_se3(scale=0.2)
        E_cur = [E_gt[0].copy(), E_gt[1].copy(),
                 np.asarray(jt.se3_compose(J(E_gt[2]), J(drift)[None]))]
        m = np.asarray(jt.se3_compose(jt.se3_inverse(J(nodes_gt[0])), J(nodes_gt[2])))
        cfg = {"SIM3_Optimizer": {"max_iterations": 60, "lambda_init": 1e-8},
               "edge_weight": 4.0}
        closers = (OnlineLoopCloser(model=None, config=cfg, device="cpu"),
                   JCloser(model=None, config=cfg))
        for c, conv, pkg in ((closers[0], T, tt), (closers[1], J, jt)):
            for k in range(3):
                c.chunks.append({"image_paths": [f"{k}_0", f"{k}_1"],
                                 "depth": conv(np.ones((2, 4, 4))), "conf": conv(np.ones((2, 4, 4))),
                                 "intrinsics": conv(np.tile(np.eye(3), (2, 1, 1))),
                                 "extrinsics": conv(E_local[k])})
            c.loop_edges.append((0, 2, pkg.Sim3(conv(1.0), conv(m[:, :3]), conv(m[:, 3]))))
        updated = closers[0]._optimize([np.asarray(e) for e in E_cur])
        ref = closers[1]._optimize([np.asarray(e) for e in E_cur])
        np.testing.assert_allclose(updated[0], E_gt[0], atol=1e-3)
        np.testing.assert_allclose(updated[2], E_gt[2], atol=0.05)
        err_before = np.abs(np.asarray(E_cur[2]) - E_gt[2]).max()
        assert np.abs(updated[2] - E_gt[2]).max() < 0.25 * err_before
        for a, b in zip(updated, ref):
            assert a.dtype == np.float32
            close(a, b, 1e-5)
