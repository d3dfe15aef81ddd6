"""Three gaps between the port's API and the JAX package's, each held
against JAX on the CPU:

* the losses take JAX's keywords: ``WeightedL2Loss(periodic=)``, its call's
  ``K=`` (the alpha term's target-derivative scale) and
  ``WeightedL2Loss2d(delta=)``;
* ``DarcyDataset.get_grid`` and ``DarcyDataset.get_scaler_sizes`` are on
  the class, as JAX's drivers call them;
* ``FourierTransformer2DLite`` takes every field of JAX's Lite and returns
  ``preds_latent=None, attn_weights=None`` whatever ``return_latent`` and
  ``return_attn_weight`` say.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data.darcy import DarcyDataset as JaxDarcyDataset
from galerkin_transformer_tpu.models import FourierTransformer2DLite as JaxLite
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_torch import FourierTransformer2DLite, load_config
from galerkin_transformer_torch.data import DarcyDataset
from galerkin_transformer_torch.train import WeightedL2Loss, WeightedL2Loss2d
from galerkin_transformer_torch.utils.weights import params_from_jax


# ------------------------------------------------------------ the losses

def _loss_inputs(n=64, b=3, seed=0):
    rng = np.random.default_rng(seed)
    preds, targets, pp, tp = (rng.standard_normal((b, n)).astype(np.float32)
                              for _ in range(4))
    return preds, targets, pp, tp


@pytest.mark.parametrize("k_kind", ["none", "field", "scalar"])
@pytest.mark.parametrize("kwargs", [
    dict(alpha=1.0, periodic=True),
    dict(alpha=1.0, periodic=False, regularizer=True, gamma=0.5),
    dict(alpha=1.0, return_norm=False, metric_reduction="L2", periodic=True),
], ids=["periodic", "regularizer", "squared"])
def test_weighted_l2_loss_takes_periodic_and_k_like_jax(kwargs, k_kind):
    """With alpha 1 and K in [1, 2) the alpha term is preds' − K·targets',
    as in JAX (losses.py:88-92); values and both gradients agree."""
    preds, targets, pp, tp = _loss_inputs()
    h = 1 / preds.shape[1]
    rng = np.random.default_rng(1)
    k = {"none": None, "field": rng.uniform(1, 2, preds.shape).astype(np.float32),
         "scalar": np.float32(1.5)}[k_kind]
    j_loss = j_losses.WeightedL2Loss(h=h, **kwargs)

    def j_total(p, ppr):
        res = j_loss(p, jnp.asarray(targets), ppr, jnp.asarray(tp),
                     K=None if k is None else jnp.asarray(k))
        return res.loss + res.reg, res

    (_, want), want_grads = jax.value_and_grad(j_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(preds), jnp.asarray(pp))
    tpreds, tpp = (torch.from_numpy(a).requires_grad_() for a in (preds, pp))
    got = WeightedL2Loss(h=h, **kwargs)(
        tpreds, torch.from_numpy(targets), tpp, torch.from_numpy(tp),
        K=None if k is None else torch.as_tensor(k))
    for name in ("loss", "reg", "ortho", "metric"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=2e-6, err_msg=name)
    (got.loss + got.reg).backward()
    for g, w in zip((tpreds.grad, tpp.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()))
    if k is not None:   # K reaches the alpha term
        plain = WeightedL2Loss(h=h, **kwargs)(*(torch.from_numpy(a) for a in
                                                (preds, targets, pp, tp)))
        assert abs(float(plain.loss) - float(got.loss.detach())) > 1e-3 * float(plain.loss)


@pytest.mark.parametrize("delta", [0.0, 1e-3, 0.5])
def test_weighted_l2_loss_2d_takes_delta_like_jax(delta):
    """``delta`` is a field of JAX's 2D loss that nothing reads: the port
    takes it and gives JAX's values."""
    rng = np.random.default_rng(2)
    n = 10
    preds, targets = (rng.standard_normal((2, n, n)).astype(np.float32) for _ in range(2))
    pp, tp = (rng.standard_normal((2, n, n, 2)).astype(np.float32) for _ in range(2))
    kw = dict(h=1 / n, regularizer=True, alpha=0.5, delta=delta)
    want = j_losses.WeightedL2Loss2d(**kw)(*(jnp.asarray(a) for a in (preds, targets, pp, tp)))
    got = WeightedL2Loss2d(**kw)(*(torch.from_numpy(a) for a in (preds, targets, pp, tp)))
    for name in ("loss", "reg", "metric"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=2e-6, err_msg=name)
    assert WeightedL2Loss2d(**kw).delta == delta


# ------------------------------------------------- DarcyDataset's statics

@pytest.mark.parametrize("n_grid,subsample,boundary", [(29, 1, True), (31, 2, False),
                                                       (141, 4, True)])
def test_darcy_dataset_get_grid_is_jax_class_attribute(n_grid, subsample, boundary):
    got = DarcyDataset.get_grid(n_grid, subsample=subsample, return_boundary=boundary)
    want = JaxDarcyDataset.get_grid(n_grid, subsample=subsample, return_boundary=boundary)
    np.testing.assert_array_equal(got, want)
    assert isinstance(DarcyDataset.__dict__["get_grid"], staticmethod)


@pytest.mark.parametrize("n_f,n_c", [(141, 43), (211, 71), (61, 21), (421, 141)])
@pytest.mark.parametrize("scale_factor", [True, False])
def test_darcy_dataset_get_scaler_sizes_is_jax_class_attribute(n_f, n_c, scale_factor):
    assert DarcyDataset.get_scaler_sizes(n_f, n_c, scale_factor=scale_factor) == \
        JaxDarcyDataset.get_scaler_sizes(n_f, n_c, scale_factor=scale_factor)
    assert isinstance(DarcyDataset.__dict__["get_scaler_sizes"], staticmethod)


# ----------------------------------------------------- the Lite's fields

N, T_IN = 12, 3


def _lite_cfg(**extra):
    cfg = load_config("ex4_navier_stokes")
    cfg.update(n_hidden=16, num_encoder_layers=2, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, node_feats=T_IN + 2, ffn_dropout=0.0)
    cfg.update(extra)
    return cfg


def _lite_inputs():
    rng = np.random.default_rng(3)
    x = np.linspace(0, 1, N, dtype=np.float32)
    grid = np.stack(np.meshgrid(x, x), axis=-1)[None].repeat(2, 0)
    return (rng.standard_normal((2, N, N, T_IN)).astype(np.float32),
            grid.reshape(2, N * N, 2), grid)


@pytest.mark.parametrize("override", [
    dict(return_attn_weight=True), dict(return_latent=True),
    dict(return_attn_weight=True, return_latent=True),
    dict(num_feat_layers=2, feat_extract_type="gcn", symmetric_init=True, batch_norm=True,
         residual_type="minus", attn_activation="gelu", decoder_type="pointwise"),
], ids=["weights", "latent", "both", "ignored-fields"])
def test_lite_takes_jax_fields_and_returns_what_jax_returns(override):
    cfg = _lite_cfg(**override)
    node, pos, grid = _lite_inputs()
    jmodel = JaxLite.from_config(cfg)
    params = jmodel.init(jax.random.key(0), jnp.asarray(node), None, jnp.asarray(pos),
                         jnp.asarray(grid))["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(node), None, jnp.asarray(pos),
                        jnp.asarray(grid))
    # every field of JAX's Lite, passed to the constructor by name
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(JaxLite)
              if f.name not in ("parent", "name")}
    model = FourierTransformer2DLite(**fields, device="cpu", seed=1)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(node), None, torch.from_numpy(pos),
                           torch.from_numpy(grid))
    assert want["preds_latent"] is None and want["attn_weights"] is None
    assert got["preds_latent"] is None and got["attn_weights"] is None
    w = np.asarray(want["preds"])
    np.testing.assert_allclose(got["preds"].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
