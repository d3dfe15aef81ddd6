"""The port's 2D Darcy training path against the JAX package's, on the CPU:
the 2D loss, the synthetic generator, the dataset field by field, one
``make_darcy_steps`` train step at the same weights (float32 and bfloat16),
accumulation, online noise, the eval step, and the ex2/ex3 drivers.

Dropout is off in every comparison: the two frameworks draw different
masks.  The drivers keep the configs' rates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import DarcyDataset as JaxDarcyDataset
from galerkin_transformer_tpu.data import DataLoader as JaxDataLoader
from galerkin_transformer_tpu.data import synthetic as j_synthetic
from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel2D
from galerkin_transformer_tpu.ops import fem as j_fem
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.steps import make_darcy_steps as j_make_steps
from galerkin_transformer_torch import FourierTransformer2D, Predictor, load_config
from galerkin_transformer_torch.data import (DarcyDataset, DataLoader, darcy_grids,
                                             get_scaler_sizes, synthetic)
from galerkin_transformer_torch.ops import fem
from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss2d,
                                              load_checkpoint, make_darcy_steps, run_train)
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.examples._darcy import SEED
from galerkin_transformer_torch.utils.weights import params_from_jax

NO_DROPOUT = dict(dropout=0.0, downscaler_dropout=0.0, upscaler_dropout=0.0,
                  ffn_dropout=0.0, encoder_dropout=0.0, decoder_dropout=0.0)
N_F, N_C = 29, 15


@pytest.fixture
def data_path(tmp_path, monkeypatch):
    """Both packages cache their synthetic data under one temporary
    directory (they use the same file name for the host generator)."""
    from galerkin_transformer_tpu.utils import config as j_config
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    monkeypatch.setattr(j_config, "DATA_PATH", str(tmp_path))
    return tmp_path


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("kwargs", [
    dict(regularizer=True, gamma=0.5),
    dict(regularizer=True, return_norm=False, metric_reduction="L2"),
    dict(regularizer=False, alpha=0.3, metric_reduction="Linf"),
    dict(regularizer=True, alpha=0.2, return_norm=False, dilation=4, beta=2.0),
    dict(regularizer=False),
])
@pytest.mark.parametrize("with_k", [True, False])
def test_weighted_l2_loss_2d_matches_jax_with_gradients(kwargs, with_k):
    rng = np.random.default_rng(0)
    n = 12
    preds, targets = (rng.standard_normal((3, n, n)).astype(np.float32) for _ in range(2))
    pp, tp = (rng.standard_normal((3, n, n, 2)).astype(np.float32) for _ in range(2))
    k = rng.uniform(3, 12, (3, n, n, 1)).astype(np.float32) if with_k else None
    h = 1 / n
    j_loss = j_losses.WeightedL2Loss2d(h=h, **kwargs)
    jk = None if k is None else jnp.asarray(k)

    def j_total(p, ppr):
        res = j_loss(p, jnp.asarray(targets), ppr, jnp.asarray(tp), K=jk)
        return res.loss + res.reg, res

    (_, want), want_grads = jax.value_and_grad(j_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(preds), jnp.asarray(pp))
    tpreds, tpp = (torch.from_numpy(a).requires_grad_() for a in (preds, pp))
    got = WeightedL2Loss2d(h=h, **kwargs)(
        tpreds, torch.from_numpy(targets), tpp, torch.from_numpy(tp),
        K=None if k is None else torch.from_numpy(k))
    assert got._fields == ("loss", "reg", "metric", "norms")
    for name in ("loss", "reg", "metric"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=2e-6, err_msg=name)
    for key in ("L2", "H1"):
        np.testing.assert_allclose(got.norms[key].numpy(), np.asarray(want.norms[key]),
                                   rtol=2e-6)
    (got.loss + got.reg).backward()
    np.testing.assert_allclose(tpreds.grad.numpy(), np.asarray(want_grads[0]), rtol=1e-4,
                               atol=1e-6 * float(np.abs(want_grads[0]).max()))
    if kwargs.get("alpha", 0) > 0:
        np.testing.assert_allclose(tpp.grad.numpy(), np.asarray(want_grads[1]), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want_grads[1]).max()))
    else:
        assert tpp.grad is None


def test_weighted_l2_loss_2d_target_noise_and_dilation():
    with pytest.raises(ValueError, match="even"):
        WeightedL2Loss2d(dilation=3)
    rng = np.random.default_rng(1)
    preds, targets = (torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32))
                      for _ in range(2))
    loss = WeightedL2Loss2d(noise=0.1)
    clean = loss(preds, targets).loss
    noisy = [loss(preds, targets, noise_generator=torch.Generator().manual_seed(5)).loss
             for _ in range(2)]
    assert noisy[0] == noisy[1] and noisy[0] != clean   # from the generator alone
    assert loss(preds, targets).loss == clean            # none without a generator


# ------------------------------------------------------------------- data

def test_darcy_fd_and_grf_2d_equal_the_jax_package():
    got = synthetic.grf_2d(3, 17, np.random.default_rng(4))
    want = j_synthetic.grf_2d(3, 17, np.random.default_rng(4))
    assert np.array_equal(got, want)
    coeff, sol = synthetic.darcy_fd(3, 19, seed=11)
    jcoeff, jsol = j_synthetic.darcy_fd(3, 19, seed=11)
    assert np.array_equal(coeff, jcoeff) and np.array_equal(sol, jsol)
    assert set(np.unique(coeff)) == {3.0, 12.0} and sol.shape == (3, 19, 19)
    assert not sol[:, 0].any() and sol[:, 1:-1, 1:-1].min() > 0   # u = 0 on the boundary


@pytest.mark.parametrize("shape,kernel,padding", [((2, 9, 9), (2, 2), True),
                                                  ((7, 8), (3, 3), True),
                                                  ((2, 8, 8), (2, 2), False),
                                                  ((5, 5), (1, 1), True)])
def test_fem_helpers_equal_the_jax_package(shape, kernel, padding):
    x = np.random.default_rng(2).standard_normal(shape)
    for method in ("mean", "max"):
        np.testing.assert_array_equal(
            fem.pooling_2d(x, kernel, method, padding),
            j_fem.pooling_2d(x, kernel, method, padding))
    for a, b in zip(fem.uniform_triangulation(shape[-1]),
                    j_fem.uniform_triangulation(shape[-1])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


DATASET_CASES = {
    "forward": dict(subsample_attn=4, subsample_nodes=2),
    "forward-pooled": dict(subsample_attn=6, subsample_nodes=2, subsample_method="average"),
    "forward-noise": dict(subsample_attn=5, subsample_nodes=1, noise=0.05),
    "inverse-average": dict(inverse_problem=True, subsample_attn=6, subsample_nodes=2,
                            subsample_inverse=6, noise=0.01),
    "inverse-interp": dict(inverse_problem=True, subsample_attn=6, subsample_nodes=3,
                           subsample_inverse=6, subsample_method_inverse="interp"),
    "inverse-plain": dict(inverse_problem=True, subsample_attn=10, subsample_nodes=2),
    "no-normalization": dict(subsample_attn=10, subsample_nodes=2, normalization=False),
    "no-boundary": dict(subsample_attn=5, subsample_nodes=1, return_boundary=False),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_darcy_dataset_matches_jax_field_by_field(data_path, case):
    kw = dict(n_grid_fine=31, n_samples_synthetic=10, **DATASET_CASES[case])
    j_train, train = JaxDarcyDataset(train_data=True, **kw), DarcyDataset(train_data=True, **kw)
    j_valid = JaxDarcyDataset(train_data=False, valid_len=4,
                              normalizer_x=j_train.normalizer_x, **kw)
    valid = DarcyDataset(train_data=False, valid_len=4, normalizer_x=train.normalizer_x, **kw)
    assert len(train) == len(j_train) == 9 and len(valid) == len(j_valid) == 4
    for ds, jds in ((train, j_train), (valid, j_valid)):
        for index in (0, len(ds) - 1):
            got, want = ds[index], jds[index]
            assert list(got) == list(want) == ["node", "coeff", "pos", "grid", "edge", "mass",
                                               "target", "target_grad"]
            for key in got:
                assert got[key].dtype == want[key].dtype == np.float32, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if kw.get("normalization", True):
        for a, b in zip(train.normalizer_y.as_tuple(), j_train.normalizer_y.as_tuple()):
            np.testing.assert_array_equal(a, b)
    if "noise" in kw:   # the noise is baked in, from the dataset's seed
        clean = DarcyDataset(train_data=True, **{**kw, "noise": 0.0})
        assert np.abs(train[0]["node"] - clean[0]["node"]).max() > 0


def test_darcy_dataset_dummy_pos_cache_and_unported_options(data_path):
    ds = DarcyDataset(n_grid_fine=13, n_samples_synthetic=4, subsample_attn=4)
    assert ds[0]["pos"].shape == (1,)              # subsample_attn < 5: a dummy pos
    cached = list(data_path.glob("darcy_synth_n13_s4_t3_seed1127802.npz"))
    assert len(cached) == 1                        # the host cache name, no generator tag
    again = DarcyDataset(n_grid_fine=13, n_samples_synthetic=4, subsample_attn=4)
    np.testing.assert_array_equal(again[1]["node"], ds[1]["node"])
    batch = next(iter(DataLoader(ds, 2)))
    assert batch["node"].shape == (2, 13, 13, 1) and batch["edge"].shape == (2, 1)
    with pytest.raises(NotImplementedError, match="return_edge"):
        DarcyDataset(n_grid_fine=13, n_samples_synthetic=4, return_edge=True)


# ------------------------------------------------------------- train step

def _cfg(block="ex2_darcy", **extra):
    cfg = load_config(block)
    down, up = get_scaler_sizes(N_F, N_C)
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4, downscaler_size=down, upscaler_size=up,
               **NO_DROPOUT)
    cfg.update(extra)
    return cfg


def _batch(seed, b=4, edge=True):
    rng = np.random.default_rng(seed)
    pos, grid = darcy_grids(N_F, N_C)
    target = rng.standard_normal((b, N_F, N_F, 1)).astype(np.float32)
    target[:, 0] = target[:, -1] = target[:, :, 0] = target[:, :, -1] = 0
    return dict(node=rng.standard_normal((b, N_F, N_F, 1)).astype(np.float32),
                coeff=rng.uniform(3, 12, (b, N_F, N_F, 1)).astype(np.float32),
                pos=pos[None].repeat(b, 0), grid=grid[None].repeat(b, 0),
                edge=np.ones((b, 1), np.float32) if edge else None,
                target=target,
                target_grad=rng.standard_normal((b, N_F, N_F, 2)).astype(np.float32))


def _normalizer(seed=20):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N_F, N_F, 1)).astype(np.float32),
            rng.uniform(0.5, 1.5, (N_F, N_F, 1)).astype(np.float32), np.float32(1e-5))


def _jax_model(cfg, batch, dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    model = JaxModel2D.from_config(cfg, **kw)
    params = model.init(jax.random.key(0), jnp.asarray(batch["node"]), None,
                        jnp.asarray(batch["pos"]), jnp.asarray(batch["grid"]))["params"]
    rng = np.random.default_rng(21)   # away from the init's zeros and ones
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    return model, params


def _jnp_batch(b):
    return {k: None if v is None else jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("dtype", [None, "bf16"], ids=["f32", "bf16"])
def test_darcy_train_step_matches_jax(dtype):
    h, total = 1 / N_F, 100
    cfg = _cfg()
    batches = [_batch(s) for s in range(2)]
    normalizer = _normalizer()
    jmodel, jparams = _jax_model(cfg, batches[0], jnp.bfloat16 if dtype else None)
    j_loss = j_losses.WeightedL2Loss2d(regularizer=True, h=h, gamma=0.5)
    j_metric = j_losses.WeightedL2Loss2d(h=h)
    tx, _ = j_schedule.adam_onecycle(1e-3, total, pct_start=0.3, grad_clip=0.99)
    jnorm = tuple(jnp.asarray(x) for x in normalizer)
    j_step, j_eval = j_make_steps(jmodel, j_loss, j_metric, tx, normalizer=jnorm,
                                  donate=False)

    def j_forward(params, batch):
        out = jmodel.apply({"params": params}, batch["node"], None, batch["pos"],
                           batch["grid"], normalizer=jnorm, deterministic=True)
        res = j_loss(out["preds"][..., 0], batch["target"][..., 0], out["preds"][..., 1:],
                     batch["target_grad"], K=batch["coeff"])
        return res.loss + res.reg

    model = FourierTransformer2D.from_config(
        cfg, device="cpu", seed=1, dtype=torch.bfloat16 if dtype else None)
    model.load_state_dict(params_from_jax(jparams))
    opt = AdamOneCycle(model.parameters(), 1e-3, total, pct_start=0.3, grad_clip=0.99)
    step, eval_step = make_darcy_steps(
        model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.5), WeightedL2Loss2d(h=h),
        opt, normalizer=normalizer)

    jb = [_jnp_batch(b) for b in batches]
    np.testing.assert_allclose(float(eval_step(batches[1])), float(j_eval(jparams, jb[1])),
                               rtol=2e-2 if dtype else 1e-4)
    j_grads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(j_forward)(jparams, jb[0])))
    params, state, rng = jparams, tx.init(jparams), jax.random.key(0)
    for i, (b, bj) in enumerate(zip(batches, jb)):
        params, state, rng, j_losses_i = j_step(params, state, bj, rng)
        got = step(b)
        assert len(got) == 2 and all(t.dim() == 0 for t in got)
        # float32: sums in another order.  bfloat16: on the CPU the JAX model runs
        # the blocked galerkin form, which rounds each block product and the
        # division by n to bfloat16 where the fused form keeps S in float32, and
        # the two frameworks' bfloat16 products round after sums in another order
        np.testing.assert_allclose([float(t) for t in got], [float(t) for t in j_losses_i],
                                   rtol=2e-2 if dtype else 1e-4)
        if i == 0:
            grads = {k: p.grad for k, p in model.named_parameters()}
            assert set(grads) == set(j_grads)
            for k, g in j_grads.items():
                scale = g.abs().max().item()
                if dtype:   # a few bfloat16 steps (2^-8) per layer, of the largest entry
                    np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0,
                                               atol=2.0 ** -3 * scale, err_msg=k)
                else:
                    np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-4,
                                               atol=1e-4 * scale, err_msg=k)
    if dtype is None:   # the updated parameters after two steps of the same optimizer
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        for k, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0, atol=2e-6,
                                       err_msg=k)


def _port_steps(cfg, seed=2, total=10, **kw):
    model = FourierTransformer2D.from_config(cfg, device="cpu", seed=seed)
    opt = AdamOneCycle(model.parameters(), 1e-3, total, pct_start=0.3, grad_clip=0.99)
    steps = make_darcy_steps(model, WeightedL2Loss2d(regularizer=True, h=1 / N_F, gamma=0.5),
                             WeightedL2Loss2d(h=1 / N_F), opt, normalizer=_normalizer(), **kw)
    return model, opt, steps


def test_darcy_accumulation_with_a_none_leaf_equals_the_full_batch():
    cfg = _cfg()
    batch = _batch(5, edge=False)
    assert batch["edge"] is None
    results = []
    for accum in (1, 2):
        model, _, (train_step, _) = _port_steps(cfg, accum_steps=accum)
        losses = [float(t) for t in train_step(batch)]
        results.append((losses, {k: p.grad.clone() for k, p in model.named_parameters()}))
    # return_norm averages square roots per sample, so halves average exactly
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for k, g in results[1][1].items():
        torch.testing.assert_close(g, results[0][1][k], rtol=1e-4,
                                   atol=1e-5 * results[0][1][k].abs().max().item())


def test_darcy_online_noise_comes_from_its_generator():
    cfg = _cfg()
    batch = _batch(6)
    with pytest.raises(ValueError, match="noise_generator"):
        _port_steps(cfg, online_noise=0.1)
    losses = []
    for seed in (3, 3, 4):
        _, _, (train_step, eval_step) = _port_steps(
            cfg, online_noise=0.1, noise_generator=torch.Generator().manual_seed(seed))
        first = float(eval_step(batch))                     # validation is untouched
        losses.append((first, [float(train_step(batch)[0]) for _ in range(2)]))
    _, _, (clean_step, _) = _port_steps(cfg)
    clean = float(clean_step(batch)[0])
    assert losses[0] == losses[1]                           # same seed, same noise
    assert losses[0][0] == losses[2][0] and losses[0][1] != losses[2][1]
    assert losses[0][1][0] != clean


def test_run_train_checkpoints_a_2d_model_with_its_normalizer(tmp_path):
    cfg = _cfg()
    model, opt, (train_step, eval_step) = _port_steps(cfg, total=4)
    normalizer = _normalizer()
    valid = [_batch(10)]
    best, result = run_train(model, train_step, eval_step, opt, [_batch(0), _batch(1)], valid,
                             epochs=2, lr_schedule=opt.lr_schedule, patience=None,
                             model_save_path=str(tmp_path), model_name="m.ckpt",
                             result_name="m.pkl", normalizer=normalizer)
    assert result.loss_train.shape == (2, 2) and np.isfinite(result.loss_train).all()
    ckpt = load_checkpoint(str(tmp_path / "m.ckpt"))
    for got, want in zip(ckpt["normalizer"], normalizer):
        np.testing.assert_array_equal(got.numpy(), want)
    pred = Predictor.from_checkpoint(FourierTransformer2D.from_config(cfg, device="cpu", seed=7),
                                     str(tmp_path / "m.ckpt"), device="cpu")
    model.load_state_dict(best)
    model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(valid[0]["node"]), None, torch.from_numpy(valid[0]["pos"]),
                     torch.from_numpy(valid[0]["grid"]),
                     normalizer=tuple(torch.as_tensor(x) for x in normalizer))["preds"]
    np.testing.assert_allclose(pred(valid[0]), want.numpy(), rtol=1e-5, atol=1e-6)
    assert not pred(valid[0])[:, 0].any()   # the Dirichlet ring, after the normalizer


# ---------------------------------------------------------------- drivers

def _record_shuffled_passes(monkeypatch):
    """Every pass over a shuffling port `DataLoader` from here on, in the
    order they start: its loader, the seed it shuffles with, the batches it
    gave, and whether it ran to its end."""
    passes = []
    own = DataLoader.__iter__

    def recording(self):
        if not self.shuffle:
            yield from own(self)
            return
        record = dict(loader=self, shuffle_seed=self.seed + self._epoch, batches=[],
                      done=False)
        passes.append(record)
        for batch in own(self):
            record["batches"].append(batch)
            yield batch
        record["done"] = True

    monkeypatch.setattr(DataLoader, "__iter__", recording)
    return passes


SMALL = ["--device", "cpu", "--n-grid-fine", "31", "--n-samples", "16", "--batch-size", "4"]


@pytest.mark.parametrize("module,argv,stem,shape", [
    ("ex2_darcy", ["--subsample-nodes", "1", "--subsample-attn", "5", "--epochs", "2"],
     "darcy_31_6gt_128d_qkv_32f_*", (31, 7)),
    ("ex2_darcy", ["--subsample-nodes", "1", "--subsample-attn", "5", "--epochs", "1",
                   "--bf16", "--accum-steps", "2"], "darcy_31_6gt_128d_qkv_32f_*", (31, 7)),
    ("ex3_darcy_inv", ["--subsample-nodes", "2", "--subsample-attn", "6", "--epochs", "2",
                       "--online-noise"], "darcy_inv_16_6gt_192d_qkv_4h_1.0e-02_*", (16, 6)),
], ids=["ex2", "ex2-bf16-accum", "ex3-online-noise"])
def test_darcy_drivers_train_on_the_cpu_and_their_checkpoint_serves(
        data_path, tmp_path, capsys, monkeypatch, module, argv, stem, shape):
    import importlib
    driver = importlib.import_module(f"galerkin_transformer_torch.examples.{module}")
    epochs = int(argv[argv.index("--epochs") + 1])
    passes = _record_shuffled_passes(monkeypatch)
    val = driver.main(SMALL + argv, model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert np.isfinite(val) and f"Best model's validation metric: {val:.4e}" in out
    assert out.count("epoch [") == epochs
    # the printed batch takes the training loader's first shuffle, as in the
    # JAX drivers: training epoch e shuffles with seed + e + 1, and its
    # batches come in the order of the JAX package's loader in that flow
    train = [p for p in passes if p["done"]]
    assert [p["shuffle_seed"] for p in train] == [SEED + e + 1 for e in range(epochs)]
    loader = train[0]["loader"]
    jax_loader = JaxDataLoader(loader.dataset, loader.batch_size, shuffle=True,
                               drop_last=True, seed=SEED)
    next(iter(jax_loader))
    want = list(jax_loader)
    assert len(want) == len(train[0]["batches"]) > 0
    for got, batch in zip(train[0]["batches"], want):
        assert got.keys() == batch.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], batch[key])
    ckpts = list((tmp_path / "ckpt").glob(stem + ".ckpt"))
    assert len(ckpts) == 1
    n_f, n_c = shape
    inverse = module == "ex3_darcy_inv"
    cfg = load_config(module)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    if inverse:
        cfg["upscaler_size"] = ((n_c, n_c), (n_c, n_c))
    pred = Predictor.from_checkpoint(
        FourierTransformer2D.from_config(cfg, device="cpu", seed=3,
                                         dtype=torch.bfloat16 if "--bf16" in argv else None),
        str(ckpts[0]), device="cpu")
    n_out = n_c if inverse else n_f
    assert pred.normalizer[0].shape == (n_out, n_out, 1)
    pos, grid = darcy_grids(n_out, n_c)
    node = np.random.default_rng(0).standard_normal((2, n_f, n_f, 1)).astype(np.float32)
    served = pred(dict(node=node, pos=pos[None].repeat(2, 0), grid=grid[None].repeat(2, 0)))
    assert served.shape == (2, n_out, n_out, 1) and np.isfinite(served).all()


@pytest.mark.parametrize("module", ["ex2_darcy", "ex3_darcy_inv"])
def test_darcy_drivers_raise_without_a_gpu_and_on_unported_flags(monkeypatch, module):
    import importlib
    driver = importlib.import_module(f"galerkin_transformer_torch.examples.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--epochs", "1", "--n-samples", "8", "--n-grid-fine", "13"])
    for flags in (["--device-data"], ["--scheduler", "plateau"], ["--rollback-on-spike", "10"],
                  ["--resume-epoch", "1"], ["--epochs-per-dispatch", "2"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            driver.main(["--device", "cpu"] + flags)
