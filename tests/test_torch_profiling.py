"""The port's ``utils/profiling.py``, the kernels' cost counts and the four
memory-profile drivers, against the JAX package on the CPU.

`compiled_cost` counts FLOPs with ``FlopCounterMode`` (2·m·n·k a product)
and bytes per dispatched op; the hand-written kernels, which that mode
cannot see, add their own analytic counts (``ops/cuda/_cost.py``), which
must equal what the mode counts for their plain versions, so that a
function counts the same on the card as on the CPU.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from galerkin_transformer_tpu.utils import profiling as JP
from galerkin_transformer_torch.examples import (encoder_memory_profile, ex1_memory_profile,
                                                 ex2_memory_profile, ex3_memory_profile)
from galerkin_transformer_torch.ops.cuda import _cost
from galerkin_transformer_torch.ops.cuda import fourier as FC
from galerkin_transformer_torch.ops.cuda import galerkin as GS
from galerkin_transformer_torch.utils import profiling as TP

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = {"ex1_memory_profile": ex1_memory_profile, "ex2_memory_profile": ex2_memory_profile,
           "ex3_memory_profile": ex3_memory_profile,
           "encoder_memory_profile": encoder_memory_profile}
TINY = {"ex1_memory_profile": ["--seq-len", "256", "--batch-size", "2"],
        "ex2_memory_profile": ["--n-grid", "29", "--n-grid-coarse", "8", "--batch-size", "2"],
        "ex3_memory_profile": ["--n-grid", "29", "--n-grid-coarse", "8", "--batch-size", "2"],
        "encoder_memory_profile": ["--seq-len", "128", "--batch-size", "2", "--d-model", "32",
                                   "--n-layers", "2"]}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_profile_result_table_is_jax_table():
    rows = [("galerkin", {"flops": 1.234e10, "bytes accessed": 3.5e9,
                          "temp_size_in_bytes": 7.25e8}, {"mean_s": 0.01234, "min_s": 0.0112}),
            ("softmax", {"flops": 9.9e11, "bytes accessed": 1.2e11,
                         "temp_size_in_bytes": float("nan")}, {"mean_s": 1.5, "min_s": 1.4}),
            ("fourier", {}, {"mean_s": 0.0, "min_s": 0.0})]
    mine, theirs = TP.ProfileResult(), JP.ProfileResult()
    for name, cost, timing in rows:
        mine.add(name, cost, timing)
        theirs.add(name, cost, timing)
    assert mine.table() == theirs.table()
    assert mine.rows[0] == theirs.rows[0]   # (nan != nan in the others)


def test_compiled_cost_of_products_matches_jax():
    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((64, 32), (32, 48), (48, 16)))
    fn = lambda x, a, b: (x @ a) @ b   # noqa: E731
    got = TP.compiled_cost(fn, *(torch.from_numpy(a) for a in (x, w1, w2)))
    want = JP.compiled_cost(fn, *(jnp.asarray(a) for a in (x, w1, w2)))
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 48 + 2 * 64 * 48 * 16
    # unfused: each product reads its operands and writes its result, as XLA counts it here
    assert got["bytes accessed"] == want["bytes accessed"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert got["output_size_in_bytes"] == want["output_size_in_bytes"]
    assert np.isnan(got["temp_size_in_bytes"])   # no device allocator on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0, 1, 2])
def test_galerkin_kernel_counts_equal_their_plain_versions(dtype, p):
    b, h, n, d_k = 2, 3, 40, 8
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn(b, h, n, d_k, generator=g).to(dtype) for _ in range(2))
    pos = torch.rand(b, n, p, generator=g).to(dtype) if p else None
    params = [torch.randn(h, d_k, generator=g) for _ in range(4)]
    d_eff = d_k + p
    ds = torch.randn(b, h, d_eff, d_eff, generator=g)
    fwd = _cost.scores_cost(b, h, n, d_k, p, k.element_size())[0]
    bwd = _cost.scores_bwd_cost(b, h, n, d_k, p, k.element_size(), dpos=bool(p))[0]
    assert fwd == _flops(GS.galerkin_scores_reference, k, v, pos, *params)
    assert bwd == _flops(GS.galerkin_scores_bwd_reference, k, v, pos, *params, ds)


@pytest.mark.parametrize("dtypes", [(torch.float32,) * 3, (torch.bfloat16,) * 3,
                                    (torch.bfloat16, torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(3, 50, 70, 9, 9), (2, 2100, 33, 5, 7)])
def test_chain_kernel_counts_equal_its_plain_version(dtypes, shape):
    bh, r, m, d, d_out = shape
    g = torch.Generator().manual_seed(1)
    a = torch.randn(bh, r, d, generator=g).to(dtypes[0])
    b = torch.randn(bh, m, d, generator=g).to(dtypes[1])
    c = torch.randn(bh, m, d_out, generator=g).to(dtypes[2])
    flops, nbytes = _cost.chain_cost(bh, r, m, d, d_out, tuple(t.element_size() for t in (a, b, c)))
    assert flops == _flops(FC.fourier_chain_reference, a, b, c)
    assert nbytes == sum(t.numel() * t.element_size() for t in (a, b, c)) + 4 * bh * r * d_out


def test_record_adds_to_the_active_counters():
    """What a wrapper does after its launch on the card: the active
    FlopCounterMode (and compiled_cost's byte count) take the kernel's
    count, under the modules that are running."""
    layer = torch.nn.Linear(4, 4)

    def work(x):
        _cost.record("galerkin_scores", 1000, 64)
        return layer(x)

    x = torch.randn(3, 4)
    with FlopCounterMode(display=False) as counter:
        work(x)
    assert counter.get_total_flops() == 1000 + 2 * 3 * 4 * 4
    assert counter.get_flop_counts()["Global"]["galerkin_scores"] == 1000
    cost = TP.compiled_cost(work, x)
    plain = TP.compiled_cost(layer, x)
    assert cost["flops"] == plain["flops"] + 1000
    assert cost["bytes accessed"] == plain["bytes accessed"] + 64
    _cost.record("fourier_chain", 5, 5)   # no counter active: nothing to do


def test_measure_returns_a_positive_slope():
    x = torch.randn(64, 64)
    t = TP.measure(lambda x: x @ x, x, iters=4, iters_lo=2, min_signal_s=1e-3)
    assert 0 < t < 1
    timing = TP.profile_step(lambda x: x @ x, x, iters=4)
    assert timing["mean_s"] > 0 and set(timing) == {"mean_s", "min_s", "std_s", "iters"}


def test_measure_keeps_no_graph_on_the_cpu():
    """Only the card captures a graph: on the CPU `measure` leaves the dict
    it was given empty, and a `ProfileResult` row has no ``graph``."""
    x = torch.randn(32, 32)
    graph = {}
    TP.measure(lambda x: x @ x, x, iters=2, iters_lo=1, min_signal_s=1e-4, graph=graph)
    assert graph == {}
    result = TP.ProfileResult()
    result.add("galerkin", TP.compiled_cost(lambda x: x @ x, x), TP.profile_step(
        lambda x: x @ x, x, iters=2))
    assert "graph" not in result.rows[0]


def test_profile_step_writes_a_trace(tmp_path):
    x = torch.randn(32, 32)
    TP.profile_step(lambda x: x @ x, x, iters=2, trace_dir=str(tmp_path))
    assert (tmp_path / "trace.json").stat().st_size > 0


def _jax_flags(name: str) -> dict:
    """flag -> default of the JAX driver's argparse, by AST."""
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            default = next((ast.literal_eval(kw.value) for kw in node.keywords
                            if kw.arg == "default"), None)
            flags[node.args[0].value] = default
    return flags


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_profile_driver_flags_are_jax_flags(name):
    port = {a.option_strings[0]: a.default for a in DRIVERS[name].parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert port.pop("--device") is None
    assert port == _jax_flags(name)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_profile_driver_runs_on_the_cpu(name, capsys):
    result = DRIVERS[name].main([*TINY[name], "--num-iter", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    types = _jax_flags(name)["--attention-types"]
    assert [r["name"] for r in result.rows] == types
    assert all(r["gflops"] > 0 and r["mean_s"] > 0 and r["hbm_gb"] > 0 for r in result.rows)
    assert result.table() in out
    assert all(f"{t}: " in out for t in types)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_profile_driver_flops_grow_with_the_batch(name):
    """The smoke reckons the CPU's count at a card's batch from batch 1:
    every count is linear in the batch."""
    parser = DRIVERS[name].parser()
    counts = {}
    for bsz in (1, 3):
        argv = [a for a in TINY[name]]
        argv[argv.index("--batch-size") + 1] = str(bsz)
        args = parser.parse_args(argv)
        for atype in ("galerkin", "softmax"):
            fn, params = DRIVERS[name].make_step(atype, args, torch.device("cpu"))
            counts[atype, bsz] = TP.compiled_cost(fn, params)["flops"]
    for atype in ("galerkin", "softmax"):
        assert counts[atype, 3] == 3 * counts[atype, 1] > 0


# ---------------------------------------------------------------- spans

def _tree(record) -> list:
    """(name, parent's name) of each span of `record`, in opening order."""
    return [(name, None if parent is None else record.names[parent])
            for name, parent in zip(record.names, record.parents)]


def test_span_is_a_shared_null_context_when_nothing_records(monkeypatch):
    """With neither the profiler nor a record on, a span enters no
    ``record_function`` and keeps nothing: one shared null context."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert TP.span("gt.serve.request") is TP.span("gt.loop.epoch")
    with TP.span("gt.serve.request"), TP.span("gt.serve.copy_in"):
        pass
    with TP.recording() as record:
        with TP.span("gt.loop.epoch"):   # the record's, still no profiler
            pass
        assert TP.span(None) is TP.span(None) and TP.span("gt.x") is not TP.span("gt.x")
    assert record.names == ["gt.loop.epoch"] and record.ends[0] >= record.starts[0] > 0
    with TP.span("gt.serve.request"):
        pass
    assert len(record) == 1


def test_recording_nests_spans_and_sums_them_by_name():
    with TP.recording() as record:
        with TP.span("gt.a"):
            with TP.span("gt.b"):
                pass
            with TP.span(None), TP.span("gt.b"):
                pass
        with TP.recording() as inner, TP.span("gt.c"):
            pass
        with TP.span("gt.a"):
            pass
    assert _tree(record) == [("gt.a", None), ("gt.b", "gt.a"), ("gt.b", "gt.a"),
                             ("gt.a", None)]
    assert _tree(inner) == [("gt.c", None)]
    totals = record.totals()
    assert set(totals) == {"gt.a", "gt.b"} and totals["gt.a"] >= totals["gt.b"] > 0


def _served():
    """A tiny ex1 model behind a CPU Predictor and one batch for it."""
    from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=16, num_encoder_layers=1, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, attention_type="galerkin")
    pred = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=0), device="cpu")
    pos = np.linspace(0, 1, 32, dtype=np.float32)[None, :, None].repeat(2, 0)
    node = np.random.default_rng(0).standard_normal((2, 32, 1)).astype(np.float32)
    return pred, dict(node=node, pos=pos, grid=pos)


def test_predictor_request_records_its_spans():
    """A CPU request is one root, ``gt.serve.request``, holding the eager
    forward; each request is a root of its own."""
    pred, batch = _served()
    with TP.recording() as record:
        pred(batch)
        pred(batch)
    assert _tree(record) == [("gt.serve.request", None),
                             ("gt.serve.eager", "gt.serve.request")] * 2
    assert [i for i, p in enumerate(record.parents) if p is None] == [0, 2]


def _runner(n_train=12, n_valid=5, batch=4, val_batch=2):
    """A tiny ex1 DeviceEpochRunner on the CPU."""
    from galerkin_transformer_torch import SimpleTransformer, load_config
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import (AdamOneCycle, DeviceEpochRunner,
                                                  WeightedL2Loss, make_burgers_steps)
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=16, num_encoder_layers=1, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, attention_type="galerkin")
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=0)
    opt = AdamOneCycle(model.parameters(), 1e-3, 20)
    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=1 / 32, gamma=0.1),
        WeightedL2Loss(h=1 / 32), opt)
    rng = np.random.default_rng(0)
    pos = np.linspace(0, 1, 32, dtype=np.float32)[:, None]
    samples = [dict(node=rng.standard_normal((32, 1)).astype(np.float32), pos=pos, grid=pos,
                    target=rng.standard_normal((32, 2)).astype(np.float32))
               for _ in range(n_train + n_valid)]
    return DeviceEpochRunner(model, train_step, eval_step, opt,
                             DataLoader(samples[:n_train], batch, shuffle=True,
                                        drop_last=True),
                             DataLoader(samples[n_train:], val_batch), verbose=False)


def test_device_loop_epoch_records_its_spans():
    """Construction stacks and copies the sets (two roots); an epoch is one
    root holding the shuffle, the train steps (one eager step span per
    batch), the validation (one eager eval step per full batch) and the
    host read; each epoch of `run_block` is a root of its own, the last
    holding the block's one host read."""
    with TP.recording() as record:
        runner = _runner()
        runner.epoch(0)
    epoch = [("gt.loop.epoch", None), ("gt.loop.shuffle", "gt.loop.epoch"),
             ("gt.loop.train", "gt.loop.epoch")] + \
        [("gt.eager.train_step", "gt.loop.train")] * 3 + \
        [("gt.loop.validate", "gt.loop.epoch")] + \
        [("gt.eager.eval_step", "gt.loop.validate")] * 2 + \
        [("gt.loop.host_read", "gt.loop.epoch")]
    assert _tree(record) == [("gt.loop.stack", None), ("gt.loop.to_device", None)] + epoch
    model = runner.model
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with TP.recording() as block:
        runner.run_block(float("inf"), best, 1, 2)
    assert _tree(block) == epoch[:-1] + epoch
    assert [block.names[i] for i, p in enumerate(block.parents) if p is None] == \
        ["gt.loop.epoch"] * 2


def test_spans_lie_on_the_profilers_clock():
    """Under ``torch.profiler`` each span is also a host event of the trace,
    whose start and end agree with the record's within 1 ms."""
    pred, batch = _served()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pred(batch)   # the profiler's first record_function
        with TP.recording() as record:
            pred(batch)
    traced = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gt.")]
    assert [n for n, _, _ in traced] == ["gt.serve.request", "gt.serve.eager"] * 2
    kept = list(zip(record.names, record.starts, record.ends))
    assert [n for n, _, _ in kept] == ["gt.serve.request", "gt.serve.eager"]
    for (name, t0, t1), (_, r0, r1) in zip(sorted(traced[2:]), sorted(kept)):
        assert abs(t0 - r0) < 1e6 and abs(t1 - r1) < 1e6, (name, t0 - r0, t1 - r1)
