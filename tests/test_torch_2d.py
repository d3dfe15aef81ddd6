"""The port's 2D path (ex2 / ex3, FourierTransformer2D) against the JAX
package's, on the CPU: the same numpy-seeded inputs go through each JAX
module and its counterpart, with the JAX weights carried over by
`params_from_jax`.

Small sizes throughout (n_hidden 32, 2 layers, 2 heads, n_f 29, n_c 15).
Everything is float32 here; tests/test_torch_bf16.py holds the bfloat16
forms.  Dropout is off in every comparison (eval mode on both sides): the
two frameworks draw different masks.

Tolerances: single modules agree to float32 rounding of sums taken in
another order (rtol 1e-4, atol 1e-5 · the output's scale); whole models to
the 1e-3 / 1e-4 of tests/test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data.darcy import DarcyDataset
from galerkin_transformer_tpu.data.normalizer import UnitGaussianNormalizer as JaxNormalizer
from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel
from galerkin_transformer_tpu.models import conv as jconv
from galerkin_transformer_tpu.models import layers as jlayers
from galerkin_transformer_tpu.models import regressor as jreg
from galerkin_transformer_tpu.models import scaler as jscaler
from galerkin_transformer_tpu.ops import fem as jfem
from galerkin_transformer_tpu.ops import interp as jinterp
from galerkin_transformer_tpu.ops import spectral as jspectral
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor
from galerkin_transformer_tpu.utils.torch_compat import convert_state_dict
from galerkin_transformer_torch import FourierTransformer2D, Predictor, load_config
from galerkin_transformer_torch.data import (UnitGaussianNormalizer, darcy_grids,
                                             get_scaler_sizes)
from galerkin_transformer_torch.models import conv as tconv
from galerkin_transformer_torch.models import layers as tlayers
from galerkin_transformer_torch.models import regressor as treg
from galerkin_transformer_torch.models import scaler as tscaler
from galerkin_transformer_torch.ops import interp as tinterp
from galerkin_transformer_torch.ops import spectral as tspectral
from galerkin_transformer_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-3, 1e-4        # whole models (tests/test_torch_model.py)
N_F, N_C = 29, 15


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _init(module, x, *args, seed=0, **kwargs):
    """JAX params of `module` as numpy, each shifted by seeded noise so that
    no parameter sits at a special value (zero biases, unit scales)."""
    params = module.init(jax.random.key(seed), jnp.asarray(x), *args, **kwargs)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _carry(module, params, jax_path, prefix):
    """Load JAX `params` into the port `module`: the tree is hung under
    `jax_path` of a model's tree, mapped by `params_from_jax`, and the
    model-level `prefix` is taken off the keys again."""
    tree = params
    for name in reversed(jax_path.split("/")):
        tree = {name: tree}
    sd = params_from_jax(tree)
    assert all(k.startswith(prefix) for k in sd), sorted(sd)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module.eval()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("size,scale", [((21, 21), None), ((29, 17), None), (8, None),
                                        (None, 0.725), (None, (0.5, 1.5)),
                                        ((15, 15), None)])
def test_bilinear_resize_matches_jax(size, scale):
    x = _x((2, 15, 15, 3), seed=1)
    want = jinterp.bilinear_resize(jnp.asarray(x), size, scale_factor=scale)
    got = tinterp.bilinear_resize(torch.from_numpy(x), size, scale_factor=scale)
    _close(got, want, atol=1e-6)
    if size == (15, 15):
        assert got.data_ptr() == torch.from_numpy(x).data_ptr()   # identity: x itself


def test_linear_resize_1d_and_interp_matrix_match_jax():
    x = _x((2, 33, 4), seed=2)
    _close(tinterp.linear_resize_1d(torch.from_numpy(x), 50),
           jinterp.linear_resize_1d(jnp.asarray(x), 50), atol=1e-6)
    for n_in, n_out in [(29, 20), (20, 15), (15, 29), (7, 1), (5, 5)]:
        np.testing.assert_array_equal(tinterp.interp_matrix(n_in, n_out),
                                      jinterp.interp_matrix(n_in, n_out))
    for n_in, s in [(29, 0.725), (141, (0.555, 0.555)), (20, 7), (20, (3, 4))]:
        assert tinterp.resolve_interp_size(n_in, s) == jinterp.resolve_interp_size(n_in, s)


def test_interp_matrix_cached_while_serving_still_trains():
    # the cached device copy must be a normal tensor even when the first
    # caller runs under inference_mode, or autograd cannot save it
    x = torch.from_numpy(_x((1, 11, 11, 2), seed=3))
    with torch.inference_mode():
        tinterp.bilinear_resize(x, (6, 7))
    y = x.clone().requires_grad_()
    tinterp.bilinear_resize(y, (6, 7)).sum().backward()
    assert torch.isfinite(y.grad).all()


def _spectral_weights(c_in, c_out, modes, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, c_in, c_out, modes, modes, 2)).astype(np.float32)
    return w[0], w[1]


@pytest.mark.parametrize("h,w,modes", [(16, 16, 4), (15, 12, 5), (9, 9, 4)])
def test_spectral_conv_2d_dft_matches_jax_and_fft(h, w, modes):
    x = _x((2, h, w, 3), seed=h)
    wp, wn = _spectral_weights(3, 5, modes, seed=w)
    jw = [jax.lax.complex(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1])) for a in (wp, wn)]
    tw = [torch.complex(torch.from_numpy(a[..., 0].copy()), torch.from_numpy(a[..., 1].copy()))
          for a in (wp, wn)]
    want = jspectral.spectral_conv_2d_dft(jnp.asarray(x), *jw)
    got = tspectral.spectral_conv_2d_dft(torch.from_numpy(x), *tw)
    _close(got, want)
    _close(tspectral.spectral_conv_2d(torch.from_numpy(x), *tw), want)


def test_spectral_conv_2d_dft_refuses_modes_above_half():
    w = torch.zeros(1, 1, 5, 5, dtype=torch.complex64)
    with pytest.raises(ValueError, match="modes"):
        tspectral.spectral_conv_2d_dft(torch.zeros(1, 16, 9, 1), w, w)


def test_dft_2d_basis_cached_while_serving_still_trains():
    x = torch.from_numpy(_x((1, 10, 10, 2), seed=4))
    w = torch.complex(torch.randn(2, 2, 3, 3), torch.randn(2, 2, 3, 3))
    with torch.inference_mode():
        tspectral.spectral_conv_2d_dft(x, w, w)
    y = x.clone().requires_grad_()
    tspectral.spectral_conv_2d_dft(y, w, w).sum().backward()
    assert torch.isfinite(y.grad).all()


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("activation", ["silu", "identity"])
def test_spectral_conv2d_layer_matches_jax(flat, activation):
    n, c_in, c_out, modes = 12, 6, 4, 5
    x = _x((2, n * n, c_in) if flat else (2, n, n, c_in), seed=5)
    jmod = jlayers.SpectralConv2d(in_dim=c_in, out_dim=c_out, modes=modes,
                                  activation=activation)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tlayers.SpectralConv2d(c_in, c_out, modes, activation=activation),
                  params, "regressor/spectral_conv0", "regressor.spectral_conv.0.")
    _close(tmod(torch.from_numpy(x)), want)


def test_spectral_conv2d_init_statistics():
    g = torch.Generator().manual_seed(0)
    m = tlayers.SpectralConv2d(8, 8, 6, generator=g)
    gain = 1.0 / 64 * np.sqrt(16)
    std = gain * np.sqrt(2.0 / (16 * 36 * 2))
    for w in m.fourier_weight:
        assert w.shape == (8, 8, 6, 6, 2)
        assert abs(float(w.detach().std()) / std - 1) < 0.05


CONV_BLOCKS = [
    dict(out_dim=5),
    dict(out_dim=5, basic_block=True, activation_type="relu"),
    dict(out_dim=5, residual=True),
    dict(out_dim=3, residual=True, basic_block=True),
    dict(out_dim=4, kernel_size=3, padding=2, dilation=2),
    dict(out_dim=4, stride=2, padding=1),
]


@pytest.mark.parametrize("kw", CONV_BLOCKS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_conv2d_res_block_matches_jax(kw):
    x = _x((2, 10, 9, 3), seed=6)
    jmod = jconv.Conv2dResBlock(**kw)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tconv.Conv2dResBlock(3, **kw), params, "downscaler/interp/conv0",
                  "downscaler.downsample.conv0.")
    _close(tmod(torch.from_numpy(x)), want)


def test_shortcut2d_matches_jax():
    x = _x((2, 6, 5, 3), seed=7)
    jmod = jconv.Shortcut2d(7)
    params = _init(jmod, x)
    tmod = _carry(tconv.Shortcut2d(3, 7), params, "downscaler/interp/conv0/res",
                  "downscaler.downsample.conv0.res.")
    _close(tmod(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [dict(), dict(residual=True, activation_type="relu"),
                                dict(padding=5)],
                         ids=["plain", "residual-relu", "padding5"])
def test_conv2d_encoder_matches_jax(kw):
    # residual needs in == out channels where the spatial size is kept
    x = _x((2, 24, 24, 9 if kw.get("residual") else 2), seed=8)
    jmod = jconv.Conv2dEncoder(out_dim=9, **kw)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tconv.Conv2dEncoder(x.shape[-1], 9, **kw), params, "downscaler/conv0",
                  "downscaler.downsample.0.")
    _close(tmod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("interp_size,kw", [
    (((21, 21), (N_C, N_C)), dict()),
    ((0.725, 0.725), dict(activation_type="relu")),
    (((20, 18), 0.5), dict(residual=True)),
], ids=["sizes", "factors", "mixed-residual"])
def test_interp2d_encoder_matches_jax(interp_size, kw):
    x = _x((2, N_F, N_F, 1), seed=9)
    jmod = jconv.Interp2dEncoder(out_dim=10, interp_size=interp_size, **kw)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tconv.Interp2dEncoder(1, 10, interp_size=interp_size, **kw), params,
                  "downscaler/interp", "downscaler.downsample.")
    _close(tmod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("kw", [dict(), dict(kernel_size=3, stride=2, padding=2, output_padding=0),
                                dict(kernel_size=2, stride=1, padding=0, output_padding=0)],
                         ids=["default", "pad2", "k2s1"])
def test_conv_transpose2d_matches_jax(kw):
    x = _x((2, 7, 6, 3), seed=10)
    jmod = jconv.ConvTranspose2d(out_dim=4, **kw)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tconv.ConvTranspose2d(3, 4, **kw), params, "upscaler/deconv0/deconv0",
                  "upscaler.upsample.0.deconv0.")
    _close(tmod(torch.from_numpy(x)), want)


def test_deconv2d_block_matches_jax():
    x = _x((2, 7, 7, 6), seed=11)
    jmod = jconv.DeConv2dBlock(hidden_dim=5, out_dim=4, activation_type="relu")
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tconv.DeConv2dBlock(6, 5, 4, activation_type="relu"), params,
                  "upscaler/deconv0", "upscaler.upsample.0.")
    _close(tmod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("kw", [dict(), dict(residual=True), dict(conv_block=False)],
                         ids=["plain", "residual", "no-conv"])
def test_interp2d_upsample_matches_jax(kw):
    x = _x((2, N_C, N_C, 6), seed=12)
    size = ((21, 21), (N_F, N_F))
    jmod = jconv.Interp2dUpsample(out_dim=6, interp_size=size, **kw)
    params = _init(jmod, x) if kw.get("conv_block", True) else {}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tconv.Interp2dUpsample(6, 6, interp_size=size, **kw)
    if params:
        _carry(tmod, params, "upscaler/interp", "upscaler.upsample.")
    _close(tmod.eval()(torch.from_numpy(x)), want)


@pytest.mark.parametrize("mode", ["interp", "conv"])
def test_downscaler_matches_jax(mode):
    n = N_F if mode == "interp" else 32
    x = _x((2, n, n, 1), seed=13)
    kw = dict(in_dim=1, out_dim=12, downsample_mode=mode, activation_type="relu",
              interp_size=((21, 21), (N_C, N_C)), dropout=0.05)
    jmod = jscaler.DownScaler(**kw)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tscaler.DownScaler(**kw), params, "downscaler", "downscaler.")
    _close(tmod(torch.from_numpy(x)), want)
    # conv: (32 / 2 / 2 = 8) -> (8 + 8 = 16, dilated and padded convs) / 2 / 2 -> 5
    assert want.shape == ((2, N_C, N_C, 12) if mode == "interp" else (2, 5, 5, 12))


@pytest.mark.parametrize("mode", ["interp", "deconv"])
def test_upscaler_matches_jax(mode):
    x = _x((2, N_C, N_C, 8) if mode == "interp" else (2, 4, 4, 8), seed=14)
    kw = dict(in_dim=8, out_dim=8, upsample_mode=mode, hidden_dim=6,
              interp_size=((21, 21), (N_F, N_F)), dropout=0.0)
    jmod = jscaler.UpScaler(**kw)
    params = _init(jmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(tscaler.UpScaler(**kw), params, "upscaler", "upscaler.")
    _close(tmod(torch.from_numpy(x)), want)


def test_scalers_refuse_unknown_modes():
    with pytest.raises(NotImplementedError):
        tscaler.DownScaler(1, 8, downsample_mode="pool")
    with pytest.raises(NotImplementedError):
        tscaler.UpScaler(8, 8, upsample_mode="nearest")


@pytest.mark.parametrize("kw", [
    dict(spacial_fc=True), dict(spacial_fc=False, last_activation=False),
    dict(spacial_fc=True, dim_feedforward=10, activation="relu", num_spectral_layers=3),
], ids=["fc", "no-last-activation", "ff10-relu-3layers"])
def test_spectral_regressor_2d_matches_jax(kw):
    n = 12
    in_dim = 9 if kw["spacial_fc"] else 6   # without fc the convs read x as it is
    x, grid = _x((2, n, n, in_dim), seed=15), _x((2, n, n, 2), seed=16)
    common = dict(in_dim=in_dim, n_hidden=6, freq_dim=6, out_dim=1, modes=4, spacial_dim=2, **kw)
    jmod = jreg.SpectralRegressor(**common)
    params = _init(jmod, x, grid=jnp.asarray(grid))
    want = jmod.apply({"params": params}, jnp.asarray(x), grid=jnp.asarray(grid))
    tmod = _carry(treg.SpectralRegressor(**common), params, "regressor", "regressor.")
    _close(tmod(torch.from_numpy(x), grid=torch.from_numpy(grid)), want)
    assert tmod.regressor[0].out_features == kw.get("dim_feedforward", 2 * 2 * 6)


@pytest.mark.parametrize("kw", [
    dict(spacial_fc=True, spacial_dim=2, num_layers=1),
    dict(spacial_fc=False, num_layers=2, activation="relu"),
    dict(spacial_fc=True, spacial_dim=2, num_layers=0),
], ids=["fc-1layer", "nofc-2layers-relu", "fc-0layers"])
def test_pointwise_regressor_matches_jax(kw):
    n = 9
    x, grid = _x((2, n, n, 7), seed=17), _x((2, n, n, 2), seed=18)
    common = dict(in_dim=7, n_hidden=5, out_dim=2, **kw)
    jmod = jreg.PointwiseRegressor(**common)
    params = _init(jmod, x, grid=jnp.asarray(grid))
    want = jmod.apply({"params": params}, jnp.asarray(x), grid=jnp.asarray(grid))
    tmod = _carry(treg.PointwiseRegressor(**common), params, "regressor", "regressor.")
    _close(tmod(torch.from_numpy(x), grid=torch.from_numpy(grid)), want)


def test_pointwise_regressor_init_gain_zeroes_biases_and_scales_weights():
    g = torch.Generator().manual_seed(0)
    m = treg.PointwiseRegressor(64, 64, 1, spacial_fc=True, spacial_dim=2,
                                init_gain=1e-2, generator=g)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            assert not p.any()
        else:
            fan_out, fan_in = p.shape
            assert p.abs().max() <= 1e-2 * np.sqrt(6.0 / (fan_in + fan_out))
            assert p.abs().max() > 0


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("n_f,n_c", [(141, 43), (211, 71), (85, 29), (29, 15), (61, 21),
                                     (421, 141)])
def test_get_scaler_sizes_matches_jax(n_f, n_c):
    for scale_factor in (True, False):
        assert (get_scaler_sizes(n_f, n_c, scale_factor)
                == DarcyDataset.get_scaler_sizes(n_f, n_c, scale_factor))
    down, up = get_scaler_sizes(n_f, n_c)
    mid = tinterp.resolve_interp_size(n_f, down[0])
    assert tinterp.resolve_interp_size(mid, down[1]) == (n_c, n_c)
    assert tuple(up[1]) == (n_f, n_f)


def test_darcy_grids_match_jax():
    pos, grid = darcy_grids(N_F, N_C)
    nodes, _ = jfem.uniform_triangulation(N_C)
    np.testing.assert_array_equal(pos, nodes[:, :2].astype(np.float32))
    np.testing.assert_array_equal(grid, DarcyDataset.get_grid(N_F).astype(np.float32))
    assert pos.shape == (N_C * N_C, 2) and grid.shape == (N_F, N_F, 2)


def test_normalizer_matches_jax():
    x = _x((16, 7, 7, 1), seed=19) * 3 + 1
    a, b = UnitGaussianNormalizer(), JaxNormalizer()
    np.testing.assert_array_equal(a.fit_transform(x), b.fit_transform(x))
    np.testing.assert_array_equal(a.transform(x[:3]), b.transform(x[:3]))
    np.testing.assert_array_equal(a.inverse_transform(x[:3]), b.inverse_transform(x[:3]))
    for s, t in zip(a.as_tuple(), b.as_tuple()):
        np.testing.assert_array_equal(s, t)
        assert np.asarray(s).dtype == np.float32


# ------------------------------------------------------------ the model

def _small_cfg(block="ex2_darcy", **extra):
    cfg = load_config(block)
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4)
    down, up = get_scaler_sizes(N_F, N_C)
    cfg.update(downscaler_size=down, upscaler_size=up)
    cfg.update(extra)
    return cfg


def _batch(n_f=N_F, n_c=N_C, b=2, seed=0):
    pos, grid = darcy_grids(n_f, n_c)
    return dict(node=_x((b, n_f, n_f, 1), seed), pos=pos[None].repeat(b, 0),
                grid=grid[None].repeat(b, 0))


def _jax_model(cfg, batch, seed=0):
    model = JaxModel.from_config(cfg)
    args = (jnp.asarray(batch["node"]), None, jnp.asarray(batch["pos"]),
            jnp.asarray(batch["grid"]))
    return model, _init(model, *args, seed=seed)


def _jax_preds(model, params, batch, **kwargs):
    return np.asarray(model.apply(
        {"params": params}, jnp.asarray(batch["node"]), None, jnp.asarray(batch["pos"]),
        jnp.asarray(batch["grid"]), **kwargs)["preds"])


def _port(cfg, params, **kwargs):
    model = FourierTransformer2D.from_config(cfg, device="cpu", seed=1, **kwargs)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _port_preds(model, batch, **kwargs):
    with torch.inference_mode():
        return model(torch.from_numpy(batch["node"]), None, torch.from_numpy(batch["pos"]),
                     torch.from_numpy(batch["grid"]), **kwargs)["preds"].numpy()


def _normalizer(n_f=N_F, seed=20):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_f, n_f, 1)).astype(np.float32),
            rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32), np.float32(1e-5))


@pytest.mark.parametrize("boundary", ["dirichlet", "free"])
@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
def test_model_matches_jax(attention_type, boundary):
    cfg = _small_cfg(attention_type=attention_type, boundary_condition=boundary)
    batch = _batch(seed=1)
    jmodel, params = _jax_model(cfg, batch)
    want = _jax_preds(jmodel, params, batch)
    got = _port_preds(_port(cfg, params), batch)
    assert got.shape == want.shape == (2, N_F, N_F, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ring = np.concatenate([got[:, 0].ravel(), got[:, -1].ravel(),
                           got[:, :, 0].ravel(), got[:, :, -1].ravel()])
    assert (not ring.any()) == (boundary == "dirichlet")
    assert np.abs(got[:, 1:-1, 1:-1]).max() > 1e-3   # the encoder's weights matter


def test_model_with_normalizer_and_boundary_value_matches_jax():
    cfg = _small_cfg()
    batch = _batch(seed=2)
    jmodel, params = _jax_model(cfg, batch)
    normalizer = _normalizer()
    bv = np.zeros((2, N_F, N_F, 1), np.float32)
    bv[:, 0] = 1.5
    want = _jax_preds(jmodel, params, batch, normalizer=normalizer,
                      boundary_value=jnp.asarray(bv))
    got = _port_preds(_port(cfg, params), batch, boundary_value=torch.from_numpy(bv),
                      normalizer=tuple(torch.as_tensor(x) for x in normalizer))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, 0], bv[:, 0])
    plain = _port_preds(_port(cfg, params), batch)
    assert np.abs(got - plain).max() > 0.1   # the normalizer was applied


def test_model_without_scalers_concatenates_pos_like_jax():
    # no downscaler_size: node lives on the coarse grid, pos is concatenated
    # and lifted by a linear layer; no upscaler_size: no upscaler
    cfg = _small_cfg(downscaler_size=None, upscaler_size=None, boundary_condition=None)
    batch = _batch(n_f=N_C, n_c=N_C, seed=3)
    jmodel, params = _jax_model(cfg, batch)
    assert "id" in params["downscaler"] and "upscaler" not in params
    want = _jax_preds(jmodel, params, batch)
    got = _port_preds(_port(cfg, params), batch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ex3_pointwise_model_matches_jax():
    cfg = _small_cfg("ex3_darcy_inv")
    assert cfg["decoder_type"] == "pointwise" and cfg["boundary_condition"] == "free"
    batch = _batch(seed=4)
    jmodel, params = _jax_model(cfg, batch)
    assert set(params["regressor"]) == {"fc", "ff0", "out"}
    want = _jax_preds(jmodel, params, batch, normalizer=_normalizer())
    got = _port_preds(_port(cfg, params), batch,
                      normalizer=tuple(torch.as_tensor(x) for x in _normalizer()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", [
    dict(layer_norm=True, attn_norm=False, residual_type="minus"),
    dict(downsample_mode="conv", upsample_mode="deconv"),
], ids=["layer-norm-minus", "conv-scalers"])
def test_model_options_match_jax(variant):
    cfg = _small_cfg(**variant)
    if variant.get("downsample_mode") == "conv":
        # two Conv2dEncoders take a side of 32 to 5; two DeConv2dBlocks
        # (padding 2 and 4, output_padding 0) take 5 -> 7 -> 13 -> 19 -> 35
        batch = _batch(n_f=32, n_c=5, seed=5)
        batch["grid"] = darcy_grids(35, 5)[1][None].repeat(2, 0)
        cfg.update(boundary_condition=None)
    else:
        batch = _batch(seed=5)
    jmodel, params = _jax_model(cfg, batch)
    want = _jax_preds(jmodel, params, batch)
    got = _port_preds(_port(cfg, params), batch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_state_dict_round_trips_through_jax_convert():
    cfg = _small_cfg()
    _, params = _jax_model(cfg, _batch())
    port = _port(cfg, params)
    back, unmatched = convert_state_dict(port.state_dict())
    assert unmatched == []
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_port_init_is_seeded_and_shaped_like_jax():
    cfg = _small_cfg()
    a = FourierTransformer2D.from_config(cfg, device="cpu", seed=5).state_dict()
    b = FourierTransformer2D.from_config(cfg, device="cpu", seed=5).state_dict()
    c = FourierTransformer2D.from_config(cfg, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    _, params = _jax_model(cfg, _batch())
    ref = params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_full_width_ex2_has_the_jax_parameter_shapes():
    # the full-width config, shapes only (no forward at this size here)
    n_f, n_c = 141, 43
    cfg = load_config("ex2_darcy")
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    port = FourierTransformer2D.from_config(cfg, device="cpu")
    shapes = jax.eval_shape(
        lambda: JaxModel.from_config(cfg).init(
            jax.random.key(0), jnp.zeros((1, n_f, n_f, 1)), None,
            jnp.zeros((1, n_c * n_c, 2)), jnp.zeros((1, n_f, n_f, 2)))["params"])
    ref = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                 shapes))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert len(port.encoder_layers) == 6 and port.encoder_layers[0].attn.d_k == 32


def test_predictor_serves_two_resolutions_like_jax():
    # scale factors, not sizes: one set of weights serves every resolution
    # (29 -> 15 and 37 -> 19 down, 15 -> 29 and 19 -> 37 up)
    cfg = _small_cfg(downscaler_size=(0.57, 0.94), upscaler_size=(1.16, 1.71))
    coarse, fine = _batch(29, 15, seed=6), _batch(37, 19, seed=7)
    jmodel, params = _jax_model(cfg, coarse)
    normalizer = (np.full((1, 1, 1), 0.3, np.float32), np.full((1, 1, 1), 2.0, np.float32),
                  np.float32(1e-5))
    pred = Predictor(_port(cfg, params), normalizer=normalizer, device="cpu")
    jpred = JaxPredictor(jmodel, params, normalizer=normalizer)
    for batch in (coarse, fine, coarse):
        out = pred(batch)
        n_f = batch["node"].shape[1]
        assert isinstance(out, np.ndarray) and out.shape == (2, n_f, n_f, 1)
        np.testing.assert_allclose(out, jpred(batch), rtol=RTOL, atol=ATOL)
        assert not out[:, 0].any() and not out[:, :, -1].any()   # Dirichlet
    assert not pred.model.training


def test_predictor_serves_a_float64_batch_like_jax():
    """A float64 batch and a float64 normalizer are served in float32, as
    ``jnp.asarray`` makes them with x64 off, and not refused."""
    cfg = _small_cfg()
    batch = {k: v.astype(np.float64) for k, v in _batch(29, 15, seed=8).items()}
    jmodel, params = _jax_model(cfg, _batch(29, 15, seed=6))
    normalizer = (np.full((1, 1, 1), 0.3), np.full((1, 1, 1), 2.0), np.float32(1e-5))
    pred = Predictor(_port(cfg, params), normalizer=normalizer, device="cpu")
    out = pred(batch)
    assert out.dtype == np.float32 and out.shape == (2, 29, 29, 1)
    want = JaxPredictor(jmodel, params, normalizer=normalizer)(batch)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FourierTransformer2D.from_config(_small_cfg())


@pytest.mark.parametrize("override", [
    dict(decoder_type="attention"), dict(batch_norm=True),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError):
        FourierTransformer2D.from_config(_small_cfg(**override), device="cpu")
