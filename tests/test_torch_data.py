"""The port's 1D Burgers data pipeline against the JAX package's: the same
seed gives the same arrays and the same batches."""
import numpy as np
import pytest

from galerkin_transformer_tpu.data import BurgersDataset as JaxDataset
from galerkin_transformer_tpu.data import DataLoader as JaxLoader
from galerkin_transformer_tpu.data import synthetic as j_synth
from galerkin_transformer_tpu.utils import config as j_config
from galerkin_transformer_torch.data import BurgersDataset, DataLoader
from galerkin_transformer_torch.data import synthetic as t_synth
from galerkin_transformer_torch.utils import config as t_config

N_FINE = 512


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Separate synthetic-data caches, so that neither package reads the
    other's file."""
    monkeypatch.setattr(j_config, "DATA_PATH", str(tmp_path / "jax"))
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "torch"))
    return tmp_path


def test_grf_1d_matches_jax_package():
    a = j_synth.grf_1d(3, 128, np.random.default_rng(4))
    b = t_synth.grf_1d(3, 128, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("viscosity", [0.01, 0.1])
def test_burgers_cole_hopf_matches_jax_package(viscosity):
    ja, ju = j_synth.burgers_cole_hopf(4, 256, viscosity, seed=7)
    ta, tu = t_synth.burgers_cole_hopf(4, 256, viscosity, seed=7)
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(ju, tu)
    assert np.isfinite(tu).all() and tu.shape == (4, 256)


@pytest.mark.parametrize("kwargs", [
    dict(subsample=4, train_data=True, train_portion=0.5),
    dict(subsample=4, train_data=False, valid_portion=100),
    dict(subsample=8, train_data=True, train_portion=0.5, super_resolution=2),
    dict(subsample=1, train_data=False, valid_portion=3),
])
def test_dataset_matches_jax_package(caches, kwargs):
    common = dict(n_grid_fine=N_FINE, n_samples_synthetic=12, **kwargs)
    jd, td = JaxDataset(**common), BurgersDataset(**common)
    assert len(jd) == len(td) > 0
    assert (caches / "torch").is_dir() and any((caches / "torch").iterdir())
    for i in range(len(td)):
        want, got = jd[i], td[i]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_reads_its_cache(caches):
    first = BurgersDataset(n_grid_fine=N_FINE, n_samples_synthetic=6)
    files = list((caches / "torch").iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
    again = BurgersDataset(n_grid_fine=N_FINE, n_samples_synthetic=6)
    np.testing.assert_array_equal(first.target, again.target)


@pytest.mark.parametrize("shuffle,drop_last,batch_size", [
    (True, True, 4), (False, False, 5), (True, False, 3)])
def test_loader_draws_the_jax_packages_batches(caches, shuffle, drop_last, batch_size):
    common = dict(n_grid_fine=N_FINE, n_samples_synthetic=22, train_portion=0.5)
    jl = JaxLoader(JaxDataset(**common), batch_size, shuffle=shuffle,
                   drop_last=drop_last, seed=3)
    tl = DataLoader(BurgersDataset(**common), batch_size, shuffle=shuffle,
                    drop_last=drop_last, seed=3)
    assert len(jl) == len(tl)
    for _ in range(2):   # two epochs: the shuffle advances with the epoch
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for want, got in zip(jb, tb):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# return_edge is ported; Gauss-Seidel smoothing of its Laplacian is not, in
# either package (ops/fem.py:get_laplacian_1d)
@pytest.mark.parametrize("kwargs", [dict(return_edge=True, smoother="gs")])
def test_unported_dataset_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        BurgersDataset(n_grid_fine=N_FINE, n_samples_synthetic=4, **kwargs)
