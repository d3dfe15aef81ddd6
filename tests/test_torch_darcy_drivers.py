"""The ex2 and ex3 Darcy drivers of the port on the CPU: trained in the
host loop (their shuffle against the JAX package's loader, their
checkpoint served), in the device loop, and refusing to run without a GPU
or on a flag value JAX's parser refuses.

Split from tests/test_torch_darcy.py, whose driver cases took most of its
time, so that a loadfile run spreads the two files over two workers.
"""
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import DataLoader as JaxDataLoader
from galerkin_transformer_torch import FourierTransformer2D, Predictor, load_config
from galerkin_transformer_torch.data import DataLoader, darcy_grids, get_scaler_sizes
from galerkin_transformer_torch.train import load_checkpoint
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils.args import SEED, get_args_2d


@pytest.fixture
def data_path(tmp_path, monkeypatch):
    """Both packages cache their synthetic data under one temporary
    directory (they use the same file name for the host generator)."""
    from galerkin_transformer_tpu.utils import config as j_config
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    monkeypatch.setattr(j_config, "DATA_PATH", str(tmp_path))
    return tmp_path


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
    # the host loop: its shuffle is the loader's, which JAX's host loop shares
    val = driver.main(SMALL + argv + ["--no-device-data"],
                      model_save_path=str(tmp_path / "ckpt"))
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


@pytest.mark.parametrize("module,argv,stem", [
    ("ex2_darcy", ["--subsample-nodes", "1", "--subsample-attn", "5", "--epochs", "1"],
     "darcy_31_6gt_128d_qkv_32f_*"),
    ("ex3_darcy_inv", ["--subsample-nodes", "2", "--subsample-attn", "6", "--epochs", "3",
                       "--online-noise", "--epochs-per-dispatch", "2"],
     "darcy_inv_16_6gt_192d_qkv_4h_1.0e-02_*"),
], ids=["ex2", "ex3-online-noise-blocks"])
def test_darcy_drivers_train_on_the_device_loop(data_path, tmp_path, capsys, module, argv,
                                                stem):
    """--device-data (the default): the data on the device, every epoch in
    the device loop (k epochs per host read with --epochs-per-dispatch),
    and a best checkpoint with its normalizer."""
    import importlib
    driver = importlib.import_module(f"galerkin_transformer_torch.examples.{module}")
    epochs = int(argv[argv.index("--epochs") + 1])
    val = driver.main(SMALL + argv, model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert np.isfinite(val) and f"Best model's validation metric: {val:.4e}" in out
    assert out.count("epoch [") == epochs and "device-resident data" in out
    assert ("1 host read per 2 epochs" in out) == ("--epochs-per-dispatch" in argv)
    ckpts = list((tmp_path / "ckpt").glob(stem + ".ckpt"))
    assert len(ckpts) == 1
    ckpt = load_checkpoint(str(ckpts[0]))
    assert ckpt["normalizer"][0].dim() == 3 and 0 <= ckpt["epoch"] < epochs
    logs = list((tmp_path / "ckpt").glob(stem + ".jsonl"))
    assert len(logs) == 1 and len(logs[0].read_text().splitlines()) == epochs


@pytest.mark.parametrize("module", ["ex2_darcy", "ex3_darcy_inv"])
def test_darcy_drivers_raise_without_a_gpu_and_on_unported_flags(monkeypatch, module):
    import importlib
    driver = importlib.import_module(f"galerkin_transformer_torch.examples.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--epochs", "1", "--n-samples", "8", "--n-grid-fine", "13"])
    # the three flags that raised until they were ported parse to JAX's
    # values (tests/test_torch_recovery.py trains with them); a value outside
    # a flag's type or choices is refused, as JAX's parser refuses it
    args = get_args_2d(argv=["--scheduler", "plateau", "--rollback-on-spike", "10",
                             "--resume-epoch", "1"])
    assert (args.scheduler, args.rollback_on_spike, args.resume_epoch) == ("plateau", 10.0, 1)
    for flags in (["--scheduler", "cosine"], ["--rollback-on-spike", "often"],
                  ["--resume-epoch", "1.5"]):
        with pytest.raises(SystemExit):
            driver.main(["--device", "cpu"] + flags)
