"""The port's pipelines (`parallel/pipeline.py`: GPipe, PipeDream 1F1B,
HetPipe) over pp groups of a gloo group of 8 CPU ranks (`tests/_ranks.py`,
one spawn), mirroring `tests/test_pipeline.py` test by test: values and
gradients against JAX's sequential tower (`jax.grad`), 1F1B against
`test_pipeline._pipedream_oracle` (JAX's slot-by-slot executor of the
timetable), at `test_pipeline.py`'s tolerances, from the same JAX-drawn
weights and batches.

The ranks lay out as JAX's meshes of the same tests: (dp, pp) = (2, 4)
for GPipe (rank = dp * 4 + pp); pp = 4 for 1F1B on ranks 0-3 (4-7 run a
copy); (dp, pp) = (2, 2) for 1F1B under dp and HetPipe on ranks 0-3 (4-7
a copy); pp = 1 on each rank; (dp, pp, mp) = (2, 2, 2) for the 3D test
(rank = dp * 4 + pp * 2 + mp). Each rank checks the stage it holds.
"""

import numpy as np
import pytest
import torch

from _ranks import run_ranks

# test_pipeline.py's shapes (its module, and JAX, are imported by the
# test process only: the ranks import torch alone)
N_STAGES, DP, D = 4, 2, 16
WORLD = 8


def _stage_fn(params, h):
    return torch.relu(h @ params["W"] + params["b"])


def _loss(y, target):
    return torch.mean((y - target) ** 2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _sgd(lr):
    return lambda p, g: {k: p[k] - lr * g[k] for k in p}


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------
def _gpipe_value(job, pp, dp_i):
    from herald_tpu_torch.parallel import pipeline as pl
    out = {}
    for M, (stacked, x) in job.items():
        n = x.shape[0] // DP
        my = pl.stage_params({k: _t(v) for k, v in stacked.items()}, pp)
        y = pl.pipeline_apply(_stage_fn, my, _t(x)[dp_i * n:(dp_i + 1) * n],
                              pp, N_STAGES, M)
        out[M] = pl.last_stage_value(y, pp, N_STAGES).numpy()
    return out


def _gpipe_grads(stacked, x, target, M, pp, dp, world, dp_i):
    """(loss summed over the group, this stage's grads summed over dp)."""
    from herald_tpu_torch.parallel import pipeline as pl
    n = x.shape[0] // DP
    z = slice(dp_i * n, (dp_i + 1) * n)
    my = {k: v.detach().requires_grad_(True)
          for k, v in pl.stage_params(stacked, pp).items()}
    with torch.enable_grad():
        y = pl.pipeline_apply(_stage_fn, my, x[z], pp, N_STAGES, M)
        loss = pl.stage_loss(lambda yy: _loss(yy, target[z]) / DP, y, pp,
                             N_STAGES)
        g = torch.autograd.grad(loss, list(my.values()))
    g = {k: dp.all_reduce_(v.contiguous()) for k, v in zip(my, g)}
    return float(world.all_reduce_(loss.detach().reshape(1))), g


def _gpipe_training(job, pp, dp, world, dp_i):
    stacked = {k: _t(v) for k, v in job["stacked"].items()}
    x, target = _t(job["x"]), _t(job["target"])
    losses = []
    for _ in range(job["steps"]):
        loss, g = _gpipe_grads(stacked, x, target, job["M"], pp, dp, world,
                               dp_i)
        losses.append(loss)
        stacked = {k: torch.cat([
            v[:pp.rank], (v[pp.rank] - job["lr"] * g[k])[None],
            v[pp.rank + 1:]]) for k, v in stacked.items()}
    return losses, {k: v[pp.rank].numpy() for k, v in stacked.items()}


def _three_d(job, mp, pp, dp, world, dp_i):
    from herald_tpu_torch.parallel import pipeline as pl
    from herald_tpu_torch.parallel import tp
    N, B, M = 2, job["B"], job["M"]
    W1 = _t(job["stacked"]["W1"])[pp.rank]
    W2 = _t(job["stacked"]["W2"])[pp.rank]
    h = W1.shape[1] // 2
    my = {"W1": W1[:, mp.rank * h:(mp.rank + 1) * h].requires_grad_(True),
          "W2": W2[mp.rank * h:(mp.rank + 1) * h].requires_grad_(True)}
    x, target = _t(job["x"]), _t(job["target"])
    z = slice(dp_i * B, (dp_i + 1) * B)

    def stage_fn(params, hh):
        zz = torch.relu(hh @ params["W1"])
        return tp.row_parallel_sharded(zz, params["W2"], mp)

    def chunk_loss(yy):
        yc = tp.my_batch_chunk(yy, B // 2, mp)
        tc = tp.my_batch_chunk(target[z], B // 2, mp)
        return _loss(yc, tc) / 4.0

    with torch.enable_grad():
        y = pl.pipeline_apply(stage_fn, my, x[z], pp, N, M)
        loss = pl.stage_loss(chunk_loss, y, pp, N)
        g = torch.autograd.grad(loss, list(my.values()))
    g = {k: dp.all_reduce_(v.contiguous()).numpy() for k, v in zip(my, g)}
    return float(world.all_reduce_(loss.detach().reshape(1))), g


def _pipedream(job, pp, n_stages, update_fn, dp=None, hetpipe=False,
               sync_every=1):
    from herald_tpu_torch.parallel import pipeline as pl
    stacked = {k: _t(v) for k, v in job["stacked"].items()}
    x, target = _t(job["x"]), _t(job["target"])
    my = pl.stage_params(stacked, pp)
    if hetpipe:
        new, losses = pl.hetpipe_apply(_stage_fn, _loss, my, x, target, pp,
                                       dp, n_stages, job["M"], update_fn,
                                       sync_every=sync_every)
    else:
        new, losses = pl.pipedream_apply(_stage_fn, _loss, my, x, target, pp,
                                         n_stages, job["M"], update_fn)
    return ({k: v.numpy() for k, v in new.items()},
            pp.all_reduce_(losses.clone()).numpy())


def _pipe_rank(rank, S_, init, out):
    torch.set_num_threads(1)
    from herald_tpu_torch.parallel import comm as C
    world = C.setup("cpu", init_method=init, rank=rank, world_size=S_)
    # every rank makes every group, in this order
    pp4 = world.split([[0, 1, 2, 3], [4, 5, 6, 7]])
    dp4 = world.split([[r, r + 4] for r in range(4)])
    pp2 = world.split([[0, 1], [2, 3], [4, 5], [6, 7]])
    dp2 = world.split([[0, 2], [1, 3], [4, 6], [5, 7]])
    one = world.split([[r] for r in range(WORLD)])
    mp3 = world.split([[0, 1], [2, 3], [4, 5], [6, 7]])
    pp3 = world.split([[0, 2], [1, 3], [4, 6], [5, 7]])
    dp3 = world.split([[r, r + 4] for r in range(4)])
    jobs = torch.load(out / "jobs.pt", weights_only=False)
    res = {"stage4": pp4.rank, "stage2": pp2.rank}
    res["value"] = _gpipe_value(jobs["value"], pp4, rank // 4)
    j = jobs["grads"]
    res["grads"] = _gpipe_grads(
        {k: _t(v) for k, v in j["stacked"].items()}, _t(j["x"]),
        _t(j["target"]), j["M"], pp4, dp4, world, rank // 4)
    res["grads"] = (res["grads"][0],
                    {k: v.numpy() for k, v in res["grads"][1].items()})
    res["training"] = _gpipe_training(jobs["training"], pp4, dp4, world,
                                      rank // 4)
    res["3d"] = _three_d(jobs["3d"], mp3, pp3, dp3, world, rank // 4)
    res["pipedream"] = {M: _pipedream(job, pp4, N_STAGES, _sgd(0.05))
                        for M, job in jobs["pipedream"].items()}
    res["single"] = _pipedream(jobs["single"], one, 1, _sgd(0.1))[0]

    def dp_sgd(p, g, lr=0.05):
        return {k: p[k] - lr * dp2.all_reduce_(g[k].contiguous()) / DP
                for k in p}
    dp_i = (rank // 2) % 2
    for name in ("dp", "hetpipe"):
        job = dict(jobs[name])
        n = job["x"].shape[0] // DP
        job["x"] = job["x"][dp_i * n:(dp_i + 1) * n]
        job["target"] = job["target"][dp_i * n:(dp_i + 1) * n]
        if name == "dp":
            p, losses = _pipedream(job, pp2, 2, dp_sgd)
            res["dp"] = (p, dp2.all_reduce_(torch.from_numpy(losses))
                         .numpy() / DP)
            continue
        res["hetpipe"] = {}
        for k in (1, 2):
            p, losses = _pipedream(job, pp2, 2, _sgd(0.05), dp=dp2,
                                   hetpipe=True, sync_every=k)
            res["hetpipe"][k] = (p, dp2.all_reduce_(torch.from_numpy(
                losses)).numpy() / DP)
        p, losses = _pipedream(job, pp2, 2, dp_sgd)
        res["hetpipe"]["lockstep"] = (p, dp2.all_reduce_(torch.from_numpy(
            losses)).numpy() / DP)
    torch.save(res, out / f"pipe.r{rank}.pt")


# ---------------------------------------------------------------------------
# the test process: JAX's weights, batches and oracles
# ---------------------------------------------------------------------------
def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import test_pipeline as jp
    assert (jp.N_STAGES, jp.DP, jp.D) == (N_STAGES, DP, D)
    out = tmp_path_factory.mktemp("pipe")
    key = jax.random.PRNGKey
    jobs, want = {}, {}
    # GPipe values, M = 4 and 8 (B = 32 over 2 dp replicas)
    jobs["value"] = {}
    stacked = jp._init_stacked(key(0), N_STAGES, D)
    x = jax.random.normal(key(1), (32, D))
    want["value"] = np.asarray(jp._sequential(stacked, x))
    for M in (4, 8):
        jobs["value"][M] = (_np(stacked), np.asarray(x))
    # GPipe grads (B = 32 a replica, M = 8)
    stacked = jp._init_stacked(key(2), N_STAGES, D)
    x = jax.random.normal(key(3), (32 * DP, D))
    target = jax.random.normal(key(4), (32 * DP, D))
    lref, gref = jax.value_and_grad(
        lambda p: jp._loss(jp._sequential(p, x), target))(stacked)
    jobs["grads"] = {"stacked": _np(stacked), "x": np.asarray(x),
                     "target": np.asarray(target), "M": 8}
    want["grads"] = (float(lref), _np(gref))
    # GPipe training, 60 SGD steps against the sequential trajectory
    steps, lr = 60, 0.05
    stacked = jp._init_stacked(key(5), N_STAGES, D)
    x = jax.random.normal(key(6), (32 * DP, D))
    target = jp._sequential(jp._init_stacked(key(7), N_STAGES, D), x)
    jobs["training"] = {"stacked": _np(stacked), "x": np.asarray(x),
                        "target": np.asarray(target), "M": 4,
                        "steps": steps, "lr": lr}
    vg = jax.jit(jax.value_and_grad(
        lambda p: jp._loss(jp._sequential(p, x), target)))
    seq, losses = stacked, []
    for _ in range(steps):
        lv, g = vg(seq)
        losses.append(float(lv))
        seq = jax.tree.map(lambda p, gg: p - lr * gg, seq, g)
    want["training"] = (losses, _np(seq))
    # 3D: (dp, pp, mp) = (2, 2, 2)
    N, D_, H, B3 = 2, 8, 16, 16
    k1, k2 = jax.random.split(key(0))
    st3 = {"W1": 0.4 * jax.random.normal(k1, (N, D_, H)),
           "W2": 0.4 * jax.random.normal(k2, (N, H, D_))}
    x = jax.random.normal(key(1), (2 * B3, D_))
    target = jax.random.normal(key(2), (2 * B3, D_))

    def seq3(p, xx):
        h = xx
        for s in range(N):
            h = jax.nn.relu(h @ p["W1"][s]) @ p["W2"][s]
        return h
    l3, g3 = jax.value_and_grad(
        lambda p: jp._loss(seq3(p, x), target))(st3)
    jobs["3d"] = {"stacked": _np(st3), "x": np.asarray(x),
                  "target": np.asarray(target), "B": B3, "M": 4}
    want["3d"] = (float(l3), _np(g3))
    # 1F1B against the slot-by-slot oracle, M = 4 and 9
    jobs["pipedream"], want["pipedream"] = {}, {}
    for M in (4, 9):
        stacked = jp._init_stacked(key(8), N_STAGES, D)
        x = jax.random.normal(key(9), (M * 8, D))
        target = jax.random.normal(key(10), (M * 8, D))
        jobs["pipedream"][M] = {"stacked": _np(stacked), "x": np.asarray(x),
                                "target": np.asarray(target), "M": M}
        want["pipedream"][M] = jp._pipedream_oracle(stacked, x, target,
                                                    N_STAGES, M, 0.05)
    # one stage: per-micro-batch SGD
    M, lr, B1 = 6, 0.1, 24
    stacked = jp._init_stacked(key(11), 1, D)
    x = jax.random.normal(key(12), (B1, D))
    target = jax.random.normal(key(13), (B1, D))
    jobs["single"] = {"stacked": _np(stacked), "x": np.asarray(x),
                      "target": np.asarray(target), "M": M}
    p = {"W": stacked["W"][0], "b": stacked["b"][0]}
    mb = B1 // M
    for m in range(M):
        g = jax.grad(lambda pp: jp._loss(
            jp._stage_fn(pp, x[m * mb:(m + 1) * mb]),
            target[m * mb:(m + 1) * mb]))(p)
        p = {k: p[k] - lr * g[k] for k in p}
    want["single"] = _np(p)
    # 1F1B under dp (N = 2, M = 4, 8 rows a replica's micro-batch) and
    # HetPipe, both from one layout of the data
    for name, seed in (("dp", 14), ("hetpipe", 20)):
        M, mbp = 4, 8
        Bd = M * mbp * DP
        stacked = jp._init_stacked(key(seed), 2, D)
        x = jax.random.normal(key(seed + 1), (Bd, D))
        target = jax.random.normal(key(seed + 2), (Bd, D))
        xi = np.asarray(x).reshape(M, DP, mbp, D)
        ti = np.asarray(target).reshape(M, DP, mbp, D)
        jobs[name] = {"stacked": _np(stacked), "M": M,
                      "x": xi.transpose(1, 0, 2, 3).reshape(Bd, D),
                      "target": ti.transpose(1, 0, 2, 3).reshape(Bd, D)}
        want[name] = jp._pipedream_oracle(
            stacked, xi.reshape(Bd, D), ti.reshape(Bd, D), 2, M, 0.05)
    torch.save(jobs, out / "jobs.pt")
    run_ranks(_pipe_rank, WORLD, out, out, timeout=300.0)
    ranks = [torch.load(out / f"pipe.r{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, want


@pytest.mark.parametrize("microbatches", [4, 8])
def test_pipeline_value_matches_sequential(runs, microbatches):
    ranks, want = runs
    n = want["value"].shape[0] // DP
    for r, rk in enumerate(ranks):
        i = r // 4
        np.testing.assert_allclose(rk["value"][microbatches],
                                   want["value"][i * n:(i + 1) * n],
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_grads_match_sequential(runs):
    """autograd through the ticks (reverse replay: GPipe's all-forward,
    all-backward schedule with micro-batch accumulation) equals jax.grad
    of the sequential tower."""
    ranks, (lref, gref) = runs[0], runs[1]["grads"]
    for rk in ranks:
        loss, g = rk["grads"]
        np.testing.assert_allclose(loss, lref, rtol=1e-6)
        for k in gref:
            np.testing.assert_allclose(g[k], gref[k][rk["stage4"]],
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_pipeline_training_converges(runs):
    ranks, (losses, seq) = runs[0], runs[1]["training"]
    for rk in ranks:
        got, params = rk["training"]
        np.testing.assert_allclose(got, losses, rtol=1e-5)
        assert got[-1] < 0.6 * got[0], got
        for k in seq:
            np.testing.assert_allclose(params[k], seq[k][rk["stage4"]],
                                       rtol=1e-4, atol=1e-6)


def test_3d_parallelism_dp_pp_mp(runs):
    """GPipe stages with the Megatron pair inside each and dp replicas:
    each mp peer seeds only its batch chunk, the grads match jax.grad of
    the sequential tower."""
    ranks, (lref, gref) = runs[0], runs[1]["3d"]
    h = gref["W1"].shape[2] // 2
    for r, rk in enumerate(ranks):
        loss, g = rk["3d"]
        pp, mp = (r // 2) % 2, r % 2
        np.testing.assert_allclose(loss, lref, rtol=1e-6)
        np.testing.assert_allclose(g["W1"],
                                   gref["W1"][pp][:, mp * h:(mp + 1) * h],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g["W2"], gref["W2"][pp][mp * h:(mp + 1)
                                                           * h],
                                   rtol=1e-5, atol=1e-7)


def _check_pipedream(got, want, stage):
    got_p, got_l = got
    want_p, want_l = want
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-7)
    for k in ("W", "b"):
        np.testing.assert_allclose(got_p[k], np.asarray(want_p[stage][k]),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"stage {stage} {k}")


@pytest.mark.parametrize("microbatches", [4, 9])
def test_pipedream_matches_schedule_oracle(runs, microbatches):
    """1F1B == the slot-by-slot oracle: the same stashed weight versions,
    per-micro-batch updates and losses; M = 9 wraps the stash ring."""
    ranks, want = runs
    for rk in ranks:
        _check_pipedream(rk["pipedream"][microbatches],
                         want["pipedream"][microbatches], rk["stage4"])


def test_pipedream_single_stage_is_sequential_sgd(runs):
    ranks, want = runs
    for rk in ranks:
        for k in want["single"]:
            np.testing.assert_allclose(rk["single"][k], want["single"][k],
                                       rtol=1e-6, atol=1e-8, err_msg=k)


def test_pipedream_dp_composition(runs):
    """dp x pp: update_fn sums the grads over dp (scaled), the replicas
    stay in lockstep and follow the combined-batch oracle."""
    ranks, want = runs
    for rk in ranks:
        _check_pipedream(rk["dp"], want["dp"], rk["stage2"])


def test_hetpipe_sync1_sgd_equals_lockstep(runs):
    """HetPipe at sync_every = 1 with local SGD equals the lockstep dp
    composition, and both JAX's combined-batch oracle; at 2 it takes
    another trajectory that still trains."""
    ranks, want = runs
    for rk in ranks:
        h = rk["hetpipe"]
        _check_pipedream(h[1], want["hetpipe"], rk["stage2"])
        want_p, want_l = h["lockstep"]
        got_p, got_l = h[1]
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-7)
        for k in ("W", "b"):
            np.testing.assert_allclose(got_p[k], want_p[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        stale_p, stale_l = h[2]
        assert max(float(np.abs(stale_p[k] - want_p[k]).max())
                   for k in ("W", "b")) > 1e-7
        assert stale_l[-1] < stale_l[0]
