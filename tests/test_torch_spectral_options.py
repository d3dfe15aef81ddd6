"""The spectral convolutions' and regressors' options against the JAX
package's, on the CPU: `SpectralConv1d` and `SpectralConv2d` with
``return_freq``, ``norm`` and ``impl="fft"``, and what `SpectralRegressor`
(``return_latent``, ``return_freq``) and `PointwiseRegressor`
(``return_latent``) return.  Single layers agree to 1e-4 / 1e-5 of the
output's scale (tests/test_torch_2d.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.models import layers as jlayers
from galerkin_transformer_tpu.models import regressor as jreg
from galerkin_transformer_torch.models import layers as tlayers
from galerkin_transformer_torch.models import regressor as treg
from galerkin_transformer_torch.utils.weights import params_from_jax


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _init(module, *args, seed=0, **kwargs):
    """JAX params of `module` as numpy, each shifted by seeded noise so that
    no parameter sits at a special value (zero biases, unit scales)."""
    params = module.init(jax.random.key(seed), *args, **kwargs)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _carry(module, params, jax_path, prefix):
    """Load JAX `params` hung under `jax_path` of a model's tree into the
    port `module`, the model-level `prefix` taken off the keys."""
    tree = params
    for name in reversed(jax_path.split("/")):
        tree = {name: tree}
    sd = params_from_jax(tree)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module.eval()


# ------------------------------------------------- spectral convolutions

@pytest.mark.parametrize("impl,norm", [("dft", "ortho"), ("fft", "ortho"), ("fft", "forward"),
                                       ("fft", "backward")])
@pytest.mark.parametrize("return_freq", [False, True])
def test_spectral_conv1d_options_match_jax(impl, norm, return_freq):
    n, c_in, c_out, modes = 32, 5, 4, 6
    x = _x((2, n, c_in), seed=4)
    kw = dict(in_dim=c_in, out_dim=c_out, modes=modes, norm=norm, impl=impl,
              return_freq=return_freq)
    jmod = jlayers.SpectralConv1d(**kw)
    params = _init(jmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tlayers.SpectralConv1d(**kw), params, "regressor/spectral_conv0",
                  "regressor.spectral_conv.0.")
    got = tmod(torch.from_numpy(x))
    if not return_freq:
        _close(got, want)
        return
    _close(got[0], want[0])
    assert got[1].shape == want[1].shape == (2, modes, c_out) and got[1].is_complex()
    _close(got[1].real, np.real(want[1]))
    _close(got[1].imag, np.imag(want[1]))


@pytest.mark.parametrize("impl,norm", [("fft", "ortho"), ("fft", "forward"), ("dft", "ortho")])
@pytest.mark.parametrize("flat", [False, True])
def test_spectral_conv2d_options_match_jax(impl, norm, flat):
    n, c_in, c_out, modes = 12, 4, 3, 4
    x = _x((2, n * n, c_in) if flat else (2, n, n, c_in), seed=5)
    kw = dict(in_dim=c_in, out_dim=c_out, modes=modes, norm=norm, impl=impl,
              return_freq=True)
    jmod = jlayers.SpectralConv2d(**kw)
    params = _init(jmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tlayers.SpectralConv2d(**kw), params, "regressor/spectral_conv0",
                  "regressor.spectral_conv.0.")
    _close(tmod(torch.from_numpy(x)), want)   # return_freq changes nothing in 2D


@pytest.mark.parametrize("return_latent,return_freq", [(True, False), (False, True),
                                                       (True, True)])
@pytest.mark.parametrize("spacial_dim", [1, 2])
def test_spectral_regressor_returns_what_jax_returns(spacial_dim, return_latent, return_freq):
    n = 16 if spacial_dim == 1 else 10
    shape = (2, n, 6) if spacial_dim == 1 else (2, n, n, 6)
    x = _x(shape, seed=6)
    kw = dict(in_dim=6, n_hidden=6, freq_dim=5, out_dim=1, modes=4, spacial_dim=spacial_dim,
              num_spectral_layers=3, return_latent=return_latent, return_freq=return_freq)
    jmod = jreg.SpectralRegressor(**kw)
    params = _init(jmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(treg.SpectralRegressor(**kw), params, "regressor", "regressor.")
    got = tmod(torch.from_numpy(x))
    _close(got[0], want[0])
    assert set(got[1]) == set(want[1]) == {"preds_freq", "preds_latent"}
    assert got[1]["preds_freq"] is None and want[1]["preds_freq"] is None
    assert len(got[1]["preds_latent"]) == len(want[1]["preds_latent"]) == \
        (3 if return_latent else 0)
    for g, w in zip(got[1]["preds_latent"], want[1]["preds_latent"]):
        _close(g, w)


def test_pointwise_regressor_returns_what_jax_returns():
    x, grid = _x((2, 7, 7, 5), seed=7), _x((2, 7, 7, 2), seed=8)
    kw = dict(in_dim=5, n_hidden=6, out_dim=1, spacial_fc=True, spacial_dim=2,
              return_latent=True)
    jmod = jreg.PointwiseRegressor(**kw)
    params = _init(jmod, jnp.asarray(x), grid=jnp.asarray(grid))
    want = jmod.apply({"params": params}, jnp.asarray(x), grid=jnp.asarray(grid))
    tmod = _carry(treg.PointwiseRegressor(**kw), params, "regressor", "regressor.")
    got = tmod(torch.from_numpy(x), grid=torch.from_numpy(grid))
    assert want[1] is None and got[1] is None
    _close(got[0], want[0])
