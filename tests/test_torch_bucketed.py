"""The PyTorch port's bucketed execution layout (``exec_mode="bucketed"``)
against the JAX package's, and its contracts within the port.

* the bucket plans (layout, slots, ``pos``, masks, indices, meta) equal the
  JAX package's bitwise: the CharLM e2e configuration, the duplicated
  quadratic, independent and full sampling, ``drop_last_steps``, varying
  ``epochs_max``, ``buckets`` in {1, 2, 4, 8}, an equalized preset (one
  bucket, the padded plan);
* within the port, padded == bucketed bitwise (params, optimizer state,
  client-state bank, metrics): presets x cohort modes x {legacy, engine},
  independent sampling, MVR App. F and exact eq. 14, qsgd / ef_qsgd uplink,
  a qsgd downlink, the train loop, the cipher RR backends against each
  other, a forced bucket overflow (warns, falls back to the padded plan);
* port bucketed against JAX bucketed: quadratic rounds at atol 1e-6, as
  ``tests/test_torch_vmapped.py`` holds the padded ones, and CharLM-tiny
  vmapped through the engine at rtol 1e-4 of each leaf's largest magnitude;
* ``unbucket`` / ``occupied``, and that only the occupied rows of each
  non-empty bucket run: a counting wrapper on the local step sees sum_b
  max(occ_b, 2) rows in the vmapped mode (a lone occupied row beside its
  masked copy, ``MIN_ROWS``) and sum_b occ_b in the sequential one, for
  their K_b steps, one RR generation a non-empty bucket; a one-row bucket's
  copy is finite, masked off and never read back (SCAFFOLD's bank equal to
  the padded run's).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.data.federated import BucketedPlan as JBucketedPlan  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import CharLMTask as JCharLM  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed.cohort import CohortEngine as JEngine  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.data.federated import (Bucket, BucketedBatch, BucketedPlan,  # noqa: E402
                                        BucketLayout, FederatedPipeline, IndexPlan,
                                        Population, RoundBatch)
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed import bucketing  # noqa: E402
from repro_torch.fed.cohort import plane as plane_mod  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.launch.train import charlm_e2e_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

COPIES = (1, 4, 9, 2, 6, 3, 1, 8)     # realized K_i spread over several buckets
TASK = DuplicatedQuadraticTask(copies=COPIES)
DIM = len(COPIES)
LOSS = make_quadratic_loss(DIM)
X0 = np.array([0.3, -0.1, 0.2, 0.05, -0.3, 0.1, 0.0, 0.4], np.float32)
N_ROUNDS = 3
# the e2e run's FL configuration (charlm_e2e_config), bucketed
E2E = dict(num_clients=32, cohort_size=8, sampling="uniform", epochs=1, local_batch=4,
           imbalance="lognormal", mean_samples=8, seed=1, exec_mode="bucketed")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(preset="fedshuffle", mode="vmapped", opt="sgd", **kw):
    return dict(num_clients=DIM, cohort_size=4, sampling="uniform", epochs=2, local_batch=2,
                algorithm=preset, local_lr=0.05, server_lr=0.8, server_opt=opt, mvr_a=0.2,
                cohort_mode=mode, drop_last_steps=1, seed=11, buckets=3, uplink_bits=4,
                uplink_chunk=2, downlink_bits=8, downlink_chunk=2) | kw


def _run(kw, path="engine", rounds=N_ROUNDS, *, rr_backend="host", wrap=None, pipe_fn=None):
    """The port's rounds on the duplicated quadratic: ``path`` "legacy"
    (host round batches) or "engine" (the cohort engine's device plans);
    ``wrap`` may replace hooks of the bound strategy, ``pipe_fn`` edit the
    pipeline before the rounds."""
    fl = FLConfig(**kw)
    pop = Population.build(fl, sizes=TASK.sizes())
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=DIM)
    if wrap is not None:
        strat = strat._replace(**wrap(strat))
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    if path == "legacy":
        pipe = FederatedPipeline(TASK, pop, fl)
        step = build_round_step(LOSS, strat, fl, device="cpu")
        next_batch = pipe.round_batch
    else:
        fl_e = dataclasses.replace(fl, engine="cohort", prefetch=0)
        eng = CohortEngine.build(TASK, pop, fl_e, rr_backend=rr_backend, device="cpu")
        pipe = eng.pipeline
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
        next_batch = eng.device_plan
    if pipe_fn is not None:
        pipe_fn(pipe)
    for r in range(rounds):
        state, mets = step(state, next_batch(r))
    return state, mets


def _tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    elif a is None:
        assert b is None, what
    else:
        assert torch.equal(a, b), what


def _assert_same_run(pad, buck, what):
    (ps, pm), (bs, bm) = pad, buck
    assert ps.rnd == bs.rnd, what
    _tree_equal(ps.params, bs.params, f"{what}: params")
    _tree_equal(ps.opt, bs.opt, f"{what}: opt")
    _tree_equal(ps.clients, bs.clients, f"{what}: bank")
    _tree_equal(pm, bm, f"{what}: metrics")


def _pad_and_bucket(kw, **run_kw):
    return (_run(kw | {"exec_mode": "padded"}, **run_kw),
            _run(kw | {"exec_mode": "bucketed"}, **run_kw))


# ---------------------------------------------------------------------------
# bucket plans against the JAX package's
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "e2e": E2E,
    "e2e_drop1": E2E | dict(drop_last_steps=1),
    "e2e_buckets1": E2E | dict(buckets=1),
    "e2e_buckets2": E2E | dict(buckets=2),
    "e2e_buckets8": E2E | dict(buckets=8),
    "e2e_independent": E2E | dict(sampling="independent"),
    "e2e_full": E2E | dict(sampling="full"),
    "e2e_fedavg_min": E2E | dict(algorithm="fedavg_min"),
    "quad": _kw(exec_mode="bucketed"),
    "quad_independent": _kw(sampling="independent", exec_mode="bucketed"),
    "quad_full": _kw(sampling="full", exec_mode="bucketed"),
    "quad_epochs_max": _kw(epochs=1, epochs_max=3, buckets=4, exec_mode="bucketed"),
}


def _pipes(kw):
    quad = kw["num_clients"] == DIM
    jfl, fl = JFL(**kw), FLConfig(**kw)
    sizes = TASK.sizes() if quad else None
    return (JPipe(None, JPop.build(jfl, sizes=sizes), jfl),
            FederatedPipeline(None, Population.build(fl, sizes=sizes), fl))


def _np_equal(got, want, what):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_bucket_plans_match_jax_bitwise(case):
    jpipe, pipe = _pipes(PLAN_CASES[case])
    assert pipe.bucket_layout == jpipe.bucket_layout, case
    bucketed = 0
    for r in range(4):
        for with_idx in (True, False):
            jp = jpipe.bucketed_plan(r, with_idx=with_idx)
            p = pipe.bucketed_plan(r, with_idx=with_idx)
            assert isinstance(p, BucketedPlan) == isinstance(jp, JBucketedPlan), (case, r)
            for name, a in zip(p.meta._fields, p.meta):
                _np_equal(a, getattr(jp.meta, name), f"{case} r{r} meta.{name}")
            if not isinstance(p, BucketedPlan):
                _np_equal(p.step_mask, jp.step_mask, f"{case} r{r} step_mask")
                if with_idx:
                    _np_equal(p.idx, jp.idx, f"{case} r{r} idx")
                continue
            bucketed += 1
            for field in ("pos", "sizes", "spe"):
                _np_equal(getattr(p, field), getattr(jp, field), f"{case} r{r} {field}")
            assert len(p.buckets) == len(jp.buckets)
            for i, (b, jb) in enumerate(zip(p.buckets, jp.buckets)):
                _np_equal(b.slots, jb.slots, f"{case} r{r} bucket {i} slots")
                _np_equal(b.step_mask, jb.step_mask, f"{case} r{r} bucket {i} mask")
                assert (b.idx is None) == (jb.idx is None) == (not with_idx)
                if with_idx:
                    _np_equal(b.idx, jb.idx, f"{case} r{r} bucket {i} idx")
    degenerate = case in ("e2e_buckets1", "e2e_fedavg_min")
    assert (bucketed == 0) == degenerate, (case, bucketed)


def test_e2e_layout_arithmetic():
    """The main path's layout: static caps cost 145 client steps a round
    against the padded 96; the occupied rows of rounds 0-3 cost 33, 42, 44
    and 32 (151 of 384), over 4, 4, 3 and 4 non-empty buckets; the rows
    that run, a lone occupied row with its masked copy (``MIN_ROWS``), 51,
    48, 44 and 50 (193 of 384)."""
    _, fl = charlm_e2e_config(exec_mode="bucketed")
    assert all(getattr(fl, k) == v for k, v in E2E.items())
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    edges, caps = pipe.bucket_layout
    assert (edges, caps) == ((2, 3, 6, 12), (8, 5, 5, 7))
    assert sum(e * c for e, c in zip(edges, caps)) == 145
    assert pipe.cohort_slots * pipe.k_max == 96
    got = []
    for r in range(4):
        plan = pipe.bucketed_plan(r, with_idx=False)
        kept, pos = bucketing.occupied(plan.buckets, plan.pos)
        occ = bucketing.occupied_rows(plan._replace(buckets=kept, pos=pos))
        got.append((len(kept), sum(n * b.step_mask.shape[1] for b, n in zip(kept, occ)),
                    sum(b.step_mask.size for b in kept),
                    sum(b.step_mask.shape[1] for b in kept), int(plan.meta.num_steps.sum())))
    assert got == [(4, 33, 51, 23, 25), (4, 42, 48, 23, 33), (3, 44, 44, 20, 31),
                   (4, 32, 50, 23, 26)]


# ---------------------------------------------------------------------------
# within the port: padded == bucketed, bitwise
# ---------------------------------------------------------------------------

EQUIV_CASES = {
    **{f"{p}-{m}-{path}": (_kw(p, m), path)
       for p in ("fedshuffle", "fednova", "fedavg_min")
       for m in ("vmapped", "sequential") for path in ("legacy", "engine")},
    **{f"{name}-{m}": (_kw(mode=m, **kw), path)
       for m in ("vmapped", "sequential")
       for name, kw, path in (
           ("independent", dict(sampling="independent"), "engine"),
           ("mvr", dict(opt="mvr"), "engine"),
           ("mvr_exact", dict(opt="mvr", mvr_exact=True), "engine"),
           ("qsgd_up", dict(uplink="qsgd"), "legacy"),
           ("ef_qsgd_up", dict(uplink="ef_qsgd"), "legacy"),
           ("qsgd_down", dict(downlink="qsgd"), "legacy"),
           ("qsgd_both", dict(uplink="qsgd", downlink="qsgd"), "engine"))},
}


@pytest.mark.parametrize("case", list(EQUIV_CASES))
def test_bucketed_matches_padded_bitwise(case):
    kw, path = EQUIV_CASES[case]
    pad, buck = _pad_and_bucket(kw, path=path)
    _assert_same_run(pad, buck, case)
    if "qsgd" in case:
        assert "total_comm_mbytes" in buck[1]
    if case.startswith(("ef_qsgd", "qsgd_down")):
        assert buck[0].clients is not None


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_train_loop_bucketed_matches_padded(mode):
    states = {}
    for exec_mode in ("padded", "bucketed"):
        fl = FLConfig(**_kw(mode=mode, engine="cohort", prefetch=0, exec_mode=exec_mode))
        pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
        res = train(LOSS, {"x": torch.from_numpy(X0.copy())}, pipe, fl, 4, log_every=0,
                    device="cpu")
        states[exec_mode] = res.state, res.metrics.rows
    (ps, prow), (bs, brow) = states["padded"], states["bucketed"]
    _tree_equal(ps.params, bs.params, "train(): params")
    assert [{k: v for k, v in r.items() if k != "elapsed_s"} for r in prow] == \
        [{k: v for k, v in r.items() if k != "elapsed_s"} for r in brow]


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_bucketed_rr_backends_agree_bitwise(mode):
    """The device streams are counter-based per position, so a [occ_b, K_b]
    generation is the prefix of the [C, K_max] one: the cipher's numpy
    mirror, its plain torch version and the kernel dispatch's CPU route
    agree under buckets, and equal the padded run."""
    kw = _kw(mode=mode, exec_mode="bucketed")
    out = {b: _run(kw, rr_backend=b) for b in ("host_feistel", "device_ref", "device")}
    for b in ("device_ref", "device"):
        _assert_same_run(out["host_feistel"], out[b], f"host_feistel vs {b}")
    _assert_same_run(_run(kw | {"exec_mode": "padded"}, rr_backend="device"), out["device"],
                     "padded vs bucketed, device RR")


@pytest.mark.parametrize("path", ["legacy", "engine"])
def test_overflow_falls_back_to_padded_plan(path):
    """A round whose slots fit no bucket with room warns and runs as the
    padded plan: same results."""
    kw = _kw(exec_mode="bucketed")
    fl = FLConfig(**kw)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    pipe._bucket_layout = BucketLayout(edges=(pipe.k_max,), caps=(1,))  # starve
    with pytest.warns(RuntimeWarning, match="bucketed layout overflow"):
        plan = pipe.bucketed_plan(0)
    assert isinstance(plan, IndexPlan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        batch = pipe.round_batch(0)
    assert isinstance(batch, RoundBatch)
    want = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()),
                             dataclasses.replace(fl, exec_mode="padded")).round_batch(0)
    np.testing.assert_array_equal(batch.data["e"], want.data["e"])
    np.testing.assert_array_equal(batch.step_mask, want.step_mask)

    def starve(p):
        p._bucket_layout = BucketLayout(edges=(p.k_max,), caps=(1,))

    with pytest.warns(RuntimeWarning, match="bucketed layout overflow"):
        starved = _run(kw, path=path, pipe_fn=starve)
    _assert_same_run(_run(kw | {"exec_mode": "padded"}, path=path), starved, "overflow")


# ---------------------------------------------------------------------------
# the helpers, and what runs
# ---------------------------------------------------------------------------


def test_unbucket_places_rows_in_slot_order_and_zeros_elsewhere():
    parts = [{"a": torch.tensor([[1.0, 2.0], [3.0, 4.0]])}, {"a": torch.tensor([[5.0, 6.0]])}]
    slots = [torch.tensor([3, 0]), torch.tensor([4])]
    out = bucketing.unbucket(iter(parts), iter(slots), 6, {"a": torch.zeros(2)})
    want = torch.tensor([[3.0, 4.0], [0, 0], [0, 0], [1.0, 2.0], [5.0, 6.0], [0, 0]])
    assert torch.equal(out["a"], want)
    assert not torch.signbit(out["a"][[1, 2, 5]]).any()          # +0, as masked slots give
    # tuples of trees, and no part at all (an empty cohort)
    d, l_ = bucketing.unbucket([({"a": torch.ones(1, 2)}, torch.tensor([7.0]))],
                               [torch.tensor([2])], 3, None)
    assert torch.equal(l_, torch.tensor([0.0, 0.0, 7.0])) and d["a"][2].tolist() == [1, 1]
    e = bucketing.unbucket([], [], 4, (torch.zeros(2, 3), torch.zeros(())))
    assert e[0].shape == (4, 2, 3) and e[1].shape == (4,) and not e[0].any()


def test_occupied_cuts_each_bucket_to_its_prefix():
    # caps (3, 2, 2): slots 5, 1 in bucket 0, none in bucket 1, slot 0 in 2
    mask = lambda c, k: np.arange(c * k, dtype=np.float32).reshape(c, k)  # noqa: E731
    buckets = (Bucket(None, None, mask(3, 2), np.array([5, 1, 0], np.int32)),
               Bucket(None, None, mask(2, 3), np.array([0, 0], np.int32)),
               Bucket(None, None, mask(2, 4), np.array([0, 0], np.int32)))
    pos = np.array([5, 1, 7, 7, 7, 0], np.int32)
    kept, new_pos = bucketing.occupied(buckets, pos)
    # slot 0 alone in bucket 2 runs beside its copy, masked off (MIN_ROWS)
    assert [b.step_mask.shape for b in kept] == [(2, 2), (2, 4)]
    assert [b.slots.tolist() for b in kept] == [[5, 1], [0, 0]]
    np.testing.assert_array_equal(kept[0].step_mask, mask(3, 2)[:2])
    np.testing.assert_array_equal(kept[1].step_mask, [mask(2, 4)[0], np.zeros(4)])
    assert new_pos.tolist() == [2, 1, 4, 4, 4, 0]
    batch = BucketedBatch(tuple(b._replace(data={"e": b.step_mask * 10}) for b in kept),
                          None, new_pos)
    got = [None if i is None else (i[0]["e"].tolist(), i[1].tolist())
           for i in bucketing.slot_inputs(batch)]
    k = [m.tolist() for m in (kept[0].step_mask, kept[1].step_mask)]
    assert got == [([10 * v for v in k[1][0]], k[1][0]), ([10 * v for v in k[0][1]], k[0][1]),
                   None, None, None, ([10 * v for v in k[0][0]], k[0][0])]
    # a layout cut already (tensor slots: a device plan) passes through
    cut = tuple(b._replace(slots=torch.from_numpy(b.slots).long()) for b in kept)
    assert bucketing.occupied(cut, new_pos) == (cut, new_pos)
    hole = (Bucket(None, None, mask(3, 2), np.array([0, 5, 0], np.int32)),)
    with pytest.raises(ValueError, match="prefix"):
        bucketing.occupied(hole, np.array([3, 3, 3, 3, 3, 1], np.int32))


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_only_occupied_rows_run(mode, monkeypatch):
    """A counting wrapper on the local step sees each non-empty bucket's
    rows for its K_b steps, no more: in the vmapped mode the occupied rows,
    a lone one with its masked copy (``MIN_ROWS``); in the sequential mode
    the occupied rows alone.  The RR streams are generated once a non-empty
    bucket, over the rows it runs."""
    kw = _kw(mode=mode, exec_mode="bucketed", sampling="independent")
    seen, gens = [], []

    def wrap(strat):
        def cohort_step(x, mom, opt, data, mask, *a, **k):
            seen.append(tuple(mask.shape))
            return strat.cohort_step(x, mom, opt, data, mask, *a, **k)

        def local_step(p, mom, opt, data, mask, *a, **k):
            seen.append((1, mask.shape[0]))
            return strat.local_step(p, mom, opt, data, mask, *a, **k)

        return dict(cohort_step=cohort_step, local_step=local_step)

    real = plane_mod.rr_indices_torch

    def counting(prekey, *a, **k):
        gens.append(prekey.shape[0])
        return real(prekey, *a, **k)

    monkeypatch.setattr(plane_mod, "rr_indices_torch", counting)
    _run(kw, rr_backend="device_ref", wrap=wrap)
    fl = FLConfig(**kw)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    occ_rows = occ_steps = run_rows = run_steps = static = n_buckets = 0
    for r in range(N_ROUNDS):
        plan = pipe.bucketed_plan(r, with_idx=False)
        assert isinstance(plan, BucketedPlan)
        kept, pos = bucketing.occupied(plan.buckets, plan.pos)
        occ = bucketing.occupied_rows(plan._replace(buckets=kept, pos=pos))
        n_buckets += len(kept)
        occ_rows += sum(occ)
        occ_steps += sum(n * b.step_mask.shape[1] for b, n in zip(kept, occ))
        run_rows += sum(b.step_mask.shape[0] for b in kept)
        run_steps += sum(b.step_mask.size for b in kept)
        static += sum(b.step_mask.size for b in plan.buckets)
    assert occ_rows < run_rows            # these rounds hold a one-row bucket
    rows, steps = (run_rows, run_steps) if mode == "vmapped" else (occ_rows, occ_steps)
    assert sum(r for r, _ in seen) == rows and sum(gens) == run_rows
    assert sum(r * k for r, k in seen) == steps < static
    assert len(gens) == n_buckets and (mode == "sequential" or len(seen) == n_buckets)


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_one_row_bucket_runs_beside_its_masked_copy(mode):
    """A bucket holding one client runs as two rows, the second a copy of
    the first with an all-zero step mask: finite data, the occupied slot's
    own eta and state rows, and nothing of it reaches the [C] stack or the
    bank.  SCAFFOLD's bank (a stateful chain) under such a layout equals
    the padded run bitwise, scratch row included."""
    kw = _kw("fedavg", mode, opt="scaffold", exec_mode="bucketed")
    fl = FLConfig(**kw)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    lone = 0
    for r in range(N_ROUNDS):
        plan = pipe.bucketed_plan(r, with_idx=True)
        kept, pos = bucketing.occupied(plan.buckets, plan.pos)
        for b, n in zip(kept, bucketing.occupied_rows(plan._replace(buckets=kept, pos=pos))):
            assert b.step_mask.shape[0] == max(n, bucketing.MIN_ROWS)
            if n == 1:
                lone += 1
                assert b.slots[0] == b.slots[1] and not b.step_mask[1].any()
                np.testing.assert_array_equal(b.idx[0], b.idx[1])
    assert lone > 0
    pad, buck = _pad_and_bucket(kw, path="engine")
    _assert_same_run(pad, buck, f"one-row buckets, {mode}")
    assert not buck[0].clients["scaffold"]["c"]["x"][-1].any()


def test_bucketed_batch_moves_occupied_rows_only():
    fl = FLConfig(**_kw(exec_mode="bucketed"))
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    from repro_torch.fed.rounds import as_device_batch

    host = pipe.round_batch(0)
    assert isinstance(host, BucketedBatch)
    dev = as_device_batch(host, "cpu")
    kept, pos = bucketing.occupied(host.buckets, host.pos)
    assert len(dev.buckets) == len(kept)
    for b, k in zip(dev.buckets, kept):
        assert b.slots.dtype == torch.int64 and b.data["e"].shape[0] == k.step_mask.shape[0]
        np.testing.assert_array_equal(b.data["e"].numpy(), k.data["e"])
    np.testing.assert_array_equal(dev.pos, pos)


@pytest.mark.parametrize("kw,err,what", [
    (dict(buckets=0), ValueError, "buckets"),
    (dict(server_opt="adam"), None, "adam"),
])
def test_bucketed_bind_errors(kw, err, what):
    """A bad layout knob raises at bind time; adam, once refused as
    unported, binds under buckets: its rounds equal the padded ones bitwise
    and the JAX package's bucketed rounds within atol 1e-6."""
    kw = _kw(exec_mode="bucketed") | kw
    if err is not None:
        with pytest.raises(err, match=what):
            build_round_step(LOSS, None, FLConfig(**kw), device="cpu")
        return
    buck = _run(kw, path="legacy")
    _assert_same_run(_run(kw | {"exec_mode": "padded"}, path="legacy"), buck, what)
    jstate, _ = _jax_quad(kw)
    _close_tree(buck[0].params["x"], jstate.params["x"], "params")
    for k in ("mu", "nu"):
        _close_tree(buck[0].opt[k]["x"], jstate.opt[k]["x"], k)


# ---------------------------------------------------------------------------
# port bucketed vs JAX bucketed
# ---------------------------------------------------------------------------


def _jax_quad(kw, rounds=N_ROUNDS):
    jfl = JFL(**kw)
    jtask = JDup(copies=COPIES)
    jpipe = JPipe(jtask, JPop.build(jfl, sizes=jtask.sizes()), jfl)
    jl = j_quad(DIM)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=DIM)
    jstate = jstrat.init({"x": jnp.asarray(X0)})
    jstep = jax.jit(j_build_step(jl, jstrat, jfl, num_clients=DIM))
    for r in range(rounds):
        jstate, jm = jstep(jstate, j_as_device(jpipe.round_batch(r)))
    return jstate, jm


def _close_tree(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], f"{what}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=1e-6, rtol=0, err_msg=what)


JAX_CASES = {f"{p}-{m}": _kw(p, m) for p in ("fedshuffle", "fednova", "fedavg", "gen")
             for m in ("vmapped", "sequential")}
JAX_CASES |= {"mvr_exact-vmapped": _kw(opt="mvr", mvr_exact=True),
              "mvr_exact-sequential": _kw(mode="sequential", opt="mvr", mvr_exact=True),
              "qsgd_both-vmapped": _kw(uplink="qsgd", downlink="qsgd")}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_bucketed_rounds_match_jax(case):
    kw = JAX_CASES[case] | {"exec_mode": "bucketed"}
    jstate, jm = _jax_quad(kw)
    state, mets = _run(kw, path="legacy")
    assert state.rnd == int(jstate.rnd)
    _close_tree(state.params["x"], jstate.params["x"], "params")
    assert sorted(state.opt) == sorted(jstate.opt)
    for k, tree in jstate.opt.items():
        _close_tree(state.opt[k]["x"], tree["x"], f"opt[{k}]")
    assert set(mets) == set(jm)
    for k in mets:
        _close_tree(float(mets[k]), float(jm[k]), k)
    if jstate.clients is not None:
        for name, entry in jstate.clients.items():
            for field, tree in entry.items():
                _close_tree(state.clients[name][field]["x"], tree["x"], f"{name}/{field}")


TINY_FL = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               cohort_mode="vmapped", seed=1, engine="cohort", rr_backend="device_ref",
               prefetch=0, exec_mode="bucketed", buckets=3)


def test_charlm_tiny_bucketed_vmapped_matches_jax():
    """CharLM-tiny, two vmapped engine rounds: the port's bucketed rounds
    within atol 1e-6 + rtol 1e-4 of each leaf's largest magnitude of JAX's
    bucketed rounds, and bitwise equal to the port's padded rounds."""
    rounds = 2
    jfl = JFL(**TINY_FL)
    jtask = JCharLM(vocab=J_TINY.vocab, seq_len=16, num_clients=8)
    jmodel = j_build_model(J_TINY)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jloss = j_make_loss(jmodel)
    jeng = JEngine.build(jtask, JPop.build(jfl), jfl)
    assert len(jeng.pipeline.bucket_layout.edges) > 1
    jstrat = j_bind(j_strategy_for(jfl), jfl, jloss, num_clients=8)
    jstep = jax.jit(j_build_step(jloss, jstrat, jfl, num_clients=8, plane=jeng.plane))
    jstate = jstrat.init(jparams)
    with jeng.round_plans(rounds) as it:
        for _, plan in it:
            assert isinstance(plan, JBucketedPlan)
            jstate, jm = jstep(jstate, plan)

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    cfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields})
    loss_fn = make_loss(build_model(cfg))
    out = {}
    for exec_mode in ("bucketed", "padded"):
        fl = FLConfig(**TINY_FL | {"exec_mode": exec_mode})
        eng = CohortEngine.build(CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=8),
                                 Population.build(fl), fl, device="cpu")
        strat = bind_strategy(None, fl, loss_fn, num_clients=8)
        step = build_round_step(loss_fn, strat, fl, plane=eng.plane, device="cpu")
        state = strat.init(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
        for r in range(rounds):
            state, mets = step(state, eng.device_plan(r))
        out[exec_mode] = state, mets
    state, mets = out["bucketed"]
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    assert state.params.keys() == want.keys()
    for k, w in want.items():
        g, w = state.params[k].numpy(), w.numpy()
        assert np.abs(g - w).max() <= 1e-6 + 1e-4 * np.abs(w).max(), k
    np.testing.assert_allclose(float(mets["local_loss"]), float(jm["local_loss"]), rtol=1e-4)
    _assert_same_run(out["padded"], out["bucketed"], "CharLM-tiny padded vs bucketed")
