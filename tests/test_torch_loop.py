"""The port's place recognition and loop closing (`loop/vocabulary.py`,
`loop/keyframe_db.py`, `loop/loop_closing.py`, `mapping/pose_graph.py`)
against the JAX package's, on the CPU, on the same seeded numpy inputs:
all of tests/test_loop.py, both tests of tests/test_vocab_scale.py and the
small-map tests of tests/test_loop_scale.py.

Vocabularies are trained by the JAX package's `train` and loaded into the
port (`weights.vocabulary_from_numpy`); the port's own `train` is held to
it bit for bit at a small size.  Tolerances:
  * word ids, candidate sets, consistency, covisibility, fusion remaps and
    masks exact; BoW vectors, idf, tf-idf scores within 1e-5;
  * `_edge_error` and its `jacfwd` Jacobian within 1e-5;
    `optimize_pose_graph` one iteration within 1e-5, 20 within 1e-3;
  * `correct_loop` with a given Sim(3) within 1e-4 (poses, points),
    `guided_rematch` exact;
  * `compute_loop_sim3`: the Sim(3) solve's RANSAC is held through
    tests/test_torch_initializer.py; here the verdict equal and the result
    within the JAX test's bars (their RANSAC streams differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.loop import keyframe_db as jdb
from dsp_slam_rgbd_tpu.loop import loop_closing as jlc
from dsp_slam_rgbd_tpu.loop import vocabulary as jvoc
from dsp_slam_rgbd_tpu.mapping import covisibility as jcov
from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.mapping import pose_graph as jpg
from dsp_slam_rgbd_tpu.ops import lie as jlie
from dsp_slam_rgbd_tpu_torch.loop import keyframe_db as tdb
from dsp_slam_rgbd_tpu_torch.loop import loop_closing as tlc
from dsp_slam_rgbd_tpu_torch.loop import vocabulary as tvoc
from dsp_slam_rgbd_tpu_torch.mapping import covisibility as tcov
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.mapping import pose_graph as tpg
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.ops import lie as tlie
from dsp_slam_rgbd_tpu_torch.weights import (bow_database_from_numpy, map_state_from_numpy,
                                             map_state_to_numpy, vocabulary_from_numpy)
import test_loop as jl
import test_loop_scale as jls
import test_vocab_scale as jvs

TCAM = tcam.Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    a = np.array(np.asarray(a))
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def port_state(st):
    return map_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")


def port_vocab(v):
    return vocabulary_from_numpy({"centroids": [np.asarray(c) for c in v.centroids],
                                  "branching": v.branching, "depth": v.depth}, "cpu")


def both_bows(jv, tv, descs):
    """BoW vectors of each descriptor set in both packages (words equal)."""
    jb, tb = [], []
    for d in descs:
        ones = np.ones(len(d), bool)
        wj = np.asarray(jvoc.quantize(jv, jnp.asarray(d), jnp.asarray(ones)))
        wt = tvoc.quantize(tv, t(d), t(ones))
        np.testing.assert_array_equal(wt.numpy(), wj)
        jb.append(jvoc.bow_vector(jnp.asarray(wj), jv.n_words))
        tb.append(tvoc.bow_vector(wt, tv.n_words))
        np.testing.assert_allclose(tb[-1].numpy(), np.asarray(jb[-1]), atol=1e-7)
    return jb, tb


# ------------------------------------------------------------ vocabulary
def test_train_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    desc = jl.rand_desc(rng, 3000)
    jv = jvoc.train(desc, branching=5, depth=2, seed=1)
    tv = tvoc.train(desc, branching=5, depth=2, seed=1, device="cpu")
    tv32 = tvoc.train(desc.view(np.int32), branching=5, depth=2, seed=1, device="cpu")
    for a, b, c in zip(jv.centroids, tv.centroids, tv32.centroids):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a))
        assert torch.equal(b, c)
    # the npz format is shared: each package loads the other's file
    jvoc.save_npz(str(tmp_path / "j.npz"), jv)
    tvoc.save_npz(str(tmp_path / "t.npz"), tv)
    for a, b in zip(tvoc.load_npz(str(tmp_path / "j.npz"), "cpu").centroids,
                    jvoc.load_npz(str(tmp_path / "t.npz")).centroids):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))


def test_vocabulary_quantization_stability():
    rng = np.random.default_rng(0)
    jv = jvoc.train(jl.rand_desc(rng, 3000), branching=5, depth=2, seed=1)
    tv = port_vocab(jv)
    assert tv.n_words == 25
    base = jl.rand_desc(rng, 100)
    pert = jl.perturb_desc(rng, base, 8)
    w0 = tvoc.quantize(tv, t(base), torch.ones(100, dtype=torch.bool))
    w1 = tvoc.quantize(tv, t(pert), torch.ones(100, dtype=torch.bool))
    np.testing.assert_array_equal(w0.numpy(), np.asarray(jvoc.quantize(
        jv, jnp.asarray(base), jnp.ones(100, bool))))
    assert (w0 == w1).float().mean() > 0.6
    w2 = tvoc.quantize(tv, t(base), torch.zeros(100, dtype=torch.bool))
    assert bool((w2 == -1).all())


def test_bow_scoring_discriminates():
    rng = np.random.default_rng(1)
    jv = jvoc.train(jl.rand_desc(rng, 4000), branching=6, depth=3)
    tv = port_vocab(jv)
    a = jl.rand_desc(rng, 200)
    a_noisy = jl.perturb_desc(rng, a, 6)
    b = jl.rand_desc(rng, 200)
    (ja, jan, jb), (ta, tan, tb) = both_bows(jv, tv, [a, a_noisy, b])
    s_same, s_diff = float(tvoc.l1_score(ta, tan)), float(tvoc.l1_score(ta, tb))
    assert abs(s_same - float(jvoc.l1_score(ja, jan))) < 1e-5
    assert abs(s_diff - float(jvoc.l1_score(ja, jb))) < 1e-5
    assert s_same > s_diff + 0.05


def test_keyframe_db_retrieval():
    rng = np.random.default_rng(2)
    jv = jvoc.train(jl.rand_desc(rng, 2000), branching=5, depth=2)
    tv = port_vocab(jv)
    K = 10
    descs = [jl.rand_desc(rng, 150) for _ in range(K)]
    jb, tb = both_bows(jv, tv, descs)
    jd, td = jdb.empty(K, jv.n_words), tdb.empty(K, tv.n_words, device="cpu")
    for k in range(K):
        jd, td = jd.add(k, jb[k]), td.add(k, tb[k])
    np.testing.assert_allclose(td.bow.numpy(), np.asarray(jd.bow), atol=1e-7)
    (qj,), (qt,) = both_bows(jv, tv, [jl.perturb_desc(rng, descs[2], 5)])
    connected = np.zeros(K, bool)
    connected[6:] = True
    keep_j, scores_j = jdb.detect_loop_candidates(jd, qj, jnp.asarray(connected),
                                                  jnp.zeros((K, K), jnp.int32))
    keep_t, scores_t = tdb.detect_loop_candidates(td, qt, t(connected),
                                                  torch.zeros(K, K, dtype=torch.int32))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), atol=1e-5)
    kept = np.nonzero(keep_t.numpy())[0]
    assert 2 in kept and scores_t[2] == scores_t[kept].max()
    # purge: a removed slot never surfaces again
    td2 = td.remove(2)
    keep2, _ = tdb.detect_loop_candidates(td2, qt, t(connected),
                                          torch.zeros(K, K, dtype=torch.int32))
    assert not bool(keep2[2]) and not bool(td2.kf_valid[2]) and float(td2.bow[2].sum()) == 0.0


def test_consistency_state():
    cs = tlc.ConsistencyState(min_consistency=3)
    assert cs.update([{1, 2}]) == []
    assert cs.update([{2, 3}]) == []
    assert cs.update([{3, 4}]) == []
    assert cs.update([{4, 5}]) == [4, 5]
    cs2 = tlc.ConsistencyState(min_consistency=3)
    cs2.update([{1}])
    cs2.update([set()])
    assert cs2.update([{1}]) == []
    # with candidates named, only the candidate is promoted (as the JAX one)
    a, b = tlc.ConsistencyState(), jlc.ConsistencyState()
    for groups in ([{1, 2}], [{2, 3}], [{3, 4}], [{4, 5}, {9}]):
        cands = [min(g) for g in groups]
        assert a.update(groups, cands) == b.update(groups, cands)


# ---------------------------------------------------------- loop closing
def test_compute_loop_sim3_and_correct():
    st, _ = jl._loop_map()
    ts = port_state(st)
    res = tlc.compute_loop_sim3(ts, TCAM, 5, 0, torch.Generator().manual_seed(0))
    jres = jlc.compute_loop_sim3(st, jl.CAM, 5, 0, jax.random.PRNGKey(0))
    assert res.ok is True and bool(jres.ok)
    expect = ts.kf_pose[5] @ tlie.inv_se3(ts.kf_pose[0])
    err = tlie.log_se3(res.t_21 @ tlie.inv_se3(expect)).numpy()
    assert np.linalg.norm(err) < 0.05
    np.testing.assert_allclose(res.t_21.numpy(), np.asarray(jres.t_21), atol=1e-3)

    # correction with a given Sim(3): both packages, then the JAX bars
    for t_qc in (np.eye(4, dtype=np.float32), np.asarray(jres.t_21)):
        st2 = jlc.correct_loop(st, jl.CAM, 5, 0, jnp.asarray(t_qc))
        ts2 = tlc.correct_loop(ts, TCAM, 5, 0, t(t_qc))
        np.testing.assert_allclose(ts2.kf_pose.numpy(), np.asarray(st2.kf_pose), atol=1e-4)
        np.testing.assert_allclose(ts2.pt_pos.numpy(), np.asarray(st2.pt_pos), atol=1e-4)
        np.testing.assert_allclose(ts2.obj_pose.numpy(), np.asarray(st2.obj_pose), atol=1e-5)
    ts2 = tlc.correct_loop(ts, TCAM, 5, 0, torch.eye(4))
    e = tlie.log_se3(ts2.kf_pose[5] @ tlie.inv_se3(ts.kf_pose[0])).numpy()
    assert np.linalg.norm(e) < 0.15
    uv = tcam.project(TCAM, tlie.transform_points(ts2.kf_pose[5], ts2.pt_pos[:60])).numpy()
    assert np.abs(uv - ts.kf_xy[0][:60].numpy()).mean() < 30.0


def test_fuse_duplicate_objects():
    st = jms.empty(max_kf=4, max_feat=8, max_pts=16, max_obj=4)
    poses = np.stack([np.eye(4)] * 4).astype(np.float32)
    poses[0, :3, 3] = [0, 0, 5]
    poses[1, :3, 3] = [0.3, 0, 5]
    poses[2, :3, 3] = [8, 0, 5]
    st = st._replace(obj_pose=jnp.asarray(poses), obj_valid=jnp.asarray([True, True, True, False]),
                     oobs_obj=jnp.asarray([0, 1, 2, -1], jnp.int32),
                     oobs_valid=jnp.asarray([True, True, True, False]),
                     pt_object=jnp.asarray([1] * 4 + [-1] * 12, jnp.int32))
    j2 = jlc.fuse_duplicate_objects(st)
    t2 = tlc.fuse_duplicate_objects(port_state(st))
    for f in ("obj_valid", "oobs_obj", "pt_object"):
        np.testing.assert_array_equal(getattr(t2, f).numpy(), np.asarray(getattr(j2, f)))
    assert t2.obj_valid.tolist() == [True, False, True, False] and int(t2.oobs_obj[1]) == 0


def test_guided_rematch_adds_matches():
    st, _ = jl._loop_map()
    rng = np.random.default_rng(11)
    d5 = jl.perturb_desc(rng, np.asarray(st.kf_desc[5]), 85)
    st = st._replace(kf_desc=st.kf_desc.at[5].set(jnp.asarray(d5)))
    ts = port_state(st)
    t_qc = st.kf_pose[5] @ jlie.inv_se3(st.kf_pose[0])
    mj = jlc.guided_rematch(st, jl.CAM, 5, 0, t_qc)
    mt = tlc.guided_rematch(ts, TCAM, 5, 0, t(t_qc))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    ok = mt.valid.numpy()
    assert ok.sum() > 40 and (mt.idx.numpy()[ok] == np.nonzero(ok)[0]).mean() > 0.95


def test_loop_rejected_below_min_inliers():
    st, _ = jl._loop_map()
    keep = np.zeros(128, bool)
    keep[:12] = True
    st = st._replace(pt_valid=jnp.asarray(keep))
    res = tlc.compute_loop_sim3(port_state(st), TCAM, 5, 0, torch.Generator().manual_seed(0))
    jres = jlc.compute_loop_sim3(st, jl.CAM, 5, 0, jax.random.PRNGKey(0))
    assert res.ok is False and not bool(jres.ok)
    assert int(res.n_inliers) < 20


def _dup_state(rng):
    """A map with revisit-side duplicates of loop-side points: KF0-1 see
    points 0..59, KF2-3 see 60..119 = the same places moved < 0.1 m, 40 of
    them with close descriptors; more than one tile on each side when
    `tile` is small."""
    st = jms.empty(max_kf=4, max_feat=64, max_pts=160, max_obj=2)
    P0 = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
    desc = jl.rand_desc(rng, 60)
    dup_desc = jl.perturb_desc(rng, desc, 4)
    dup_desc[40:] = jl.rand_desc(rng, 20)                  # far descriptors
    pos = np.zeros((160, 3), np.float32)
    pos[:60] = P0
    pos[60:120] = P0 + rng.uniform(-0.05, 0.05, (60, 3))
    pd = np.zeros((160, 8), np.uint32)
    pd[:60], pd[60:120] = desc, dup_desc
    feat_pt = np.full((4, 64), -1, np.int32)
    feat_pt[0, :60] = feat_pt[1, :60] = np.arange(60)
    feat_pt[2, :60] = feat_pt[3, :60] = np.arange(60, 120)
    valid = np.zeros(160, bool)
    valid[:120] = True
    return st._replace(kf_valid=jnp.ones(4, bool), kf_feat_valid=jnp.ones((4, 64), bool),
                       kf_feat_pt=jnp.asarray(feat_pt), pt_pos=jnp.asarray(pos),
                       pt_valid=jnp.asarray(valid), pt_desc=jnp.asarray(pd))


@pytest.mark.parametrize("tile", [2048, 16])
def test_fuse_duplicate_points(tile, monkeypatch):
    st = _dup_state(np.random.default_rng(4))
    gq, gc = np.array([False, False, True, True]), np.array([True, True, False, False])
    j2, jr = jlc.fuse_duplicate_points(st, jnp.asarray(gq), jnp.asarray(gc))
    t2, tr = tlc.fuse_duplicate_points(port_state(st), t(gq), t(gc), tile=tile)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(t2.pt_valid.numpy(), np.asarray(j2.pt_valid))
    np.testing.assert_array_equal(t2.kf_feat_pt.numpy(), np.asarray(j2.kf_feat_pt))
    r = tr.numpy()
    assert (r[60:100] == np.arange(40)).all() and (r[100:120] == np.arange(100, 120)).all()


# ------------------------------------------------------------ pose graph
def _graph(rng, K=6, fix_scale=False):
    xs = np.concatenate([rng.normal(0, 0.5, (K, 3)), rng.normal(0, 0.2, (K, 3)),
                         rng.normal(0, 0.1 if not fix_scale else 0.0, (K, 1))], 1)
    truth = np.asarray(jax.vmap(jlie.exp_sim3)(jnp.asarray(xs, jnp.float32)))
    ei = np.array([0, 1, 2, 3, 4, 0, 1, 5], np.int32)
    ej = np.array([1, 2, 3, 4, 5, 2, 3, 0], np.int32)
    meas = np.asarray(jax.vmap(jpg.relative_sim3)(jnp.asarray(truth[ej]), jnp.asarray(truth[ei])))
    noise = np.asarray(jax.vmap(jlie.exp_sim3)(jnp.asarray(
        rng.normal(0, 0.05, (K, 7)) * [1, 1, 1, 1, 1, 1, 0 if fix_scale else 1], jnp.float32)))
    init = np.einsum("kij,kjl->kil", noise, truth).astype(np.float32)
    return truth, init, ei, ej, meas.astype(np.float32)


def test_edge_error_and_jacobian():
    rng = np.random.default_rng(5)
    truth, init, ei, ej, meas = _graph(rng)
    for fix in (False, True):
        def jfun(Si, Sj, Sji):
            z = jnp.zeros(14)
            return (jpg._edge_error(z, Si, Sj, Sji, fix),
                    jax.jacfwd(jpg._edge_error)(z, Si, Sj, Sji, fix))

        ej_, Jj = jax.vmap(jfun)(jnp.asarray(init[ei]), jnp.asarray(init[ej]), jnp.asarray(meas))
        et, Jt = tpg.edge_errors_and_jacobians(t(init[ei]), t(init[ej]), t(meas), fix)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej_), atol=1e-5)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-5)


@pytest.mark.parametrize("iters,tol", [(1, 1e-5), (20, 1e-3)])
def test_optimize_pose_graph(iters, tol):
    rng = np.random.default_rng(6)
    for fix in (False, True):
        truth, init, ei, ej, meas = _graph(rng, fix_scale=fix)
        valid, fixed = np.ones(6, bool), np.zeros(6, bool)
        fixed[0] = True
        init[0] = truth[0]
        mask = np.ones(len(ei), bool)
        rj = jpg.optimize_pose_graph(*map(jnp.asarray, (init, valid, fixed, ei, ej, meas, mask)),
                                     n_iters=iters, fix_scale=fix)
        rt = tpg.optimize_pose_graph(*map(t, (init, valid, fixed, ei, ej, meas, mask)),
                                     n_iters=iters, fix_scale=fix)
        np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=tol)
        assert abs(float(rt.cost) - float(rj.cost)) <= tol * max(1.0, float(rj.cost))
        if iters == 20:
            np.testing.assert_allclose(rt.poses.numpy(), truth, atol=1e-3)


# ------------------------------------------------- retrieval at scale
@pytest.fixture(scope="module")
def scale_world():
    """tests/test_vocab_scale.py's aliased world and its depth-4 vocabulary
    (trained once, by the JAX package, on 110,000 descriptors)."""
    rng = np.random.default_rng(7)
    kfs = jvs._make_world(rng)
    train_desc = np.concatenate(kfs + [jvs._rand_desc(rng, jvs.N_TRAIN
                                                       - jvs.N_KF * jvs.DESC_PER_KF)])
    jv = jvoc.train(train_desc, branching=8, depth=4, seed=0)
    return kfs, jv, port_vocab(jv)


def test_retrieval_precision_at_scale(scale_world):
    kfs, jv, tv = scale_world
    assert tv.n_words == 4096
    N = jvs.N_KF
    jb, tb = both_bows(jv, tv, kfs)
    jd, td = jdb.empty(N, jv.n_words), tdb.empty(N, tv.n_words, device="cpu")
    for k in range(N):
        jd, td = jd.add(k, jb[k]), td.add(k, tb[k])
    zj, zt = jnp.zeros((N, N)), torch.zeros(N, N)
    true_scores = [float(tvoc.l1_score(td.bow, tb[q][None])[q - 60]) for q in range(60, N)]
    false_hits = 0
    for q in range(60, N):
        connected = np.zeros(N, bool)
        connected[max(q - 10, 0): q + 1] = True
        for mask_true in (False, True):
            c = connected.copy()
            c[q - 60] = mask_true
            kj, sj = jdb.detect_loop_candidates(jd, jb[q], jnp.asarray(c), zj)
            kt, st = tdb.detect_loop_candidates(td, tb[q], t(c), zt)
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
            keep, scores = kt.numpy(), st.numpy()
            if not mask_true:   # the true revisit retrieved and ranked first
                assert keep[q - 60]
                dist = keep & ~c
                dist[q - 60] = False
                assert not dist.any() or scores[q - 60] > scores[dist].max()
            else:               # no aliased retrieval in the true-match band
                cand = keep & ~c
                false_hits += int(cand.any() and scores[cand].max() >= min(true_scores))
    assert false_hits == 0


def test_tfidf_improves_margin_at_bootstrap_vocab():
    rng = np.random.default_rng(7)
    kfs = jvs._make_world(rng)
    jv = jvoc.train(np.concatenate(kfs + [jvs._rand_desc(rng, 40_000)]), branching=10,
                    depth=3, seed=0)
    tv = port_vocab(jv)
    jb, tb = both_bows(jv, tv, kfs)
    bows = torch.stack(tb)
    idf_t = tvoc.compute_idf(bows, torch.ones(jvs.N_KF, dtype=torch.bool))
    idf_j = jvoc.compute_idf(jnp.stack(jb), jnp.ones(jvs.N_KF, bool))
    np.testing.assert_allclose(idf_t.numpy(), np.asarray(idf_j), atol=1e-5)
    db = tdb.BowDatabase(bows, torch.ones(jvs.N_KF, dtype=torch.bool))
    jdb_ = jdb.BowDatabase(jnp.stack(jb), jnp.ones(jvs.N_KF, bool))
    for q in (60, 75, 99):
        np.testing.assert_allclose(tdb._tfidf_scores(db, tb[q]).numpy(),
                                   np.asarray(jdb._tfidf_scores(jdb_, jb[q])), atol=1e-5)

    def margins(weights):
        W = bows * weights[None]
        W = W / torch.clamp_min(W.sum(1, keepdim=True), 1e-12)
        out = []
        for q in range(60, jvs.N_KF):
            s = tvoc.l1_score(W, W[q][None])
            mask = torch.ones(jvs.N_KF, dtype=torch.bool)
            mask[max(q - 10, 0): q + 1] = False
            sm = torch.where(mask, s, -1.0)
            assert int(torch.argmax(sm)) == q - 60
            dist = sm.clone()
            dist[q - 60] = -1.0
            out.append(float(sm[q - 60] - dist.max()))
        return np.asarray(out)

    m_tf, m_idf = margins(torch.ones(tv.n_words)), margins(idf_t)
    assert m_idf.mean() > m_tf.mean() * 1.02 and m_idf.min() > m_tf.min() * 1.02


def test_grouped_matches_dense_small():
    rng = np.random.default_rng(0)
    K = 32
    st = jls._random_map(rng, K, 64, 512, n_live_kf=28, n_live_pts=400, pts_per_kf=48)
    db = jls._random_db(rng, K, 128, st.kf_valid)
    ts = port_state(st)
    td = bow_database_from_numpy({"bow": np.asarray(db.bow), "kf_valid": np.asarray(db.kf_valid)},
                                 "cpu")
    connected = np.asarray((jcov.covisibility_row(st, 20) >= jcov.MIN_WEIGHT).at[20].set(True))
    W = tcov.covisibility_matrix(ts)
    keep_d, scores_d = tdb.detect_loop_candidates(td, td.bow[20], t(connected), W)
    cand, scores_g, rows = tdb.detect_loop_candidates_grouped(td, td.bow[20], t(connected), ts,
                                                              top_l=K)
    cj, sj, rj = jdb.detect_loop_candidates_grouped(db, db.bow[20], jnp.asarray(connected), st,
                                                    top_l=K)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rj))
    np.testing.assert_allclose(scores_g.numpy(), np.asarray(sj), atol=1e-5)
    assert set(int(c) for c in cand if c >= 0) == set(np.nonzero(keep_d.numpy())[0].tolist())
    np.testing.assert_allclose(scores_g.numpy(), scores_d.numpy(), rtol=1e-6)
    keep_r, _ = tdb.detect_reloc_candidates(td, td.bow[20], W)
    cand_r, _ = tdb.detect_reloc_candidates_grouped(td, td.bow[20], ts, top_l=K)
    cand_rj, _ = jdb.detect_reloc_candidates_grouped(db, db.bow[20], st, top_l=K)
    np.testing.assert_array_equal(cand_r.numpy(), np.asarray(cand_rj))
    assert set(int(c) for c in cand_r if c >= 0) == set(np.nonzero(keep_r.numpy())[0].tolist())


def test_chunked_covisibility_matrix_exact():
    rng = np.random.default_rng(1)
    st = jls._random_map(rng, 37, 48, 300, n_live_kf=30, n_live_pts=250, pts_per_kf=32)
    ts = port_state(st)
    M = tms.membership_matrix(ts).numpy().astype(np.int32)
    want = M @ M.T
    np.fill_diagonal(want, 0)
    got = tcov.covisibility_matrix(ts, chunk=16).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jcov.covisibility_matrix(st, chunk=16)))
    assert map_state_to_numpy(ts)["kf_desc"].dtype == np.uint32
