"""Device-resident epoch loop (counterpart of ``train/device_loop.py``).

The host loop of `trainer.run_train` copies every batch to the device and
launches each step's kernels from Python, so a step takes its host time,
not its device time.  The JAX package runs an epoch as one jitted program;
the port's counterpart is a CUDA graph of one train step, captured once
and replayed for every step:

  * both datasets go onto the model's device once (`stack_dataset`);
  * each epoch shuffles on the device: `torch.randperm` from a generator
    seeded by the loader's seed and the epoch index;
  * a step gathers its batch from the device-resident set into static
    buffers (``index_select`` at a device step index, no copy from the
    host), runs ``train_step``, updates the parameter EMA and writes its
    losses into a device buffer.  On a CUDA device the first
    ``WARMUP_STEPS`` steps run eagerly on the capture stream (real steps of
    the first epoch), the next one is captured (a capture runs nothing) and
    every step from there on is a replay of that graph; a capture or replay
    that fails raises.  On the CPU every step runs eagerly;
  * validation runs over the validation set, pre-batched on the device:
    the full batches through one more captured step (an eval step at a
    device batch index, after one eager warm-up step), the ragged tail
    eagerly;
  * the host reads the per-step losses and the validation metric once per
    epoch, or once per block of k epochs (`run_block`, which keeps the best
    metric and parameters on the device).

An epoch is the span ``gt.loop.epoch`` (``utils/profiling.py::span``),
holding ``gt.loop.shuffle``, ``gt.loop.train`` (the steps' launches: the
train step's ``gt.eager``, ``gt.capture`` and ``gt.replay.train_step``),
``gt.loop.validate`` (the eval step's spans) and ``gt.loop.host_read``;
construction's ``gt.loop.stack`` and ``gt.loop.to_device`` are set-up.

Semantics vs the host loop: the same batch maths (the same ``train_step``),
but the shuffle stream is ``torch.randperm`` on the device instead of
numpy's (and not ``jax.random.permutation`` either: the two packages'
device loops shuffle in other orders, as their dropout masks differ), and
the validation mean is weighted by batch size (the host loop averages
per-batch means, which differs only when the last batch is ragged).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.cuda._graph import Replayed
from ..utils.profiling import span
from .schedule import ClippedAdam

# eager steps on the capture stream before the capture: they make what a
# step builds or allocates on first use (the kernels, their ticket pools and
# occupancy, the optimizer's moments and table, cuBLAS's workspace) outside
# the graph
WARMUP_STEPS = 2
EVAL_WARMUP_STEPS = 1


def stack_dataset(dataset) -> Dict[str, Optional[np.ndarray]]:
    """Stack every sample of a map-style dataset into one array per key
    (``None`` leaves stay ``None``)."""
    items = [dataset[i] for i in range(len(dataset))]
    return {k: None if items[0][k] is None else np.stack([it[k] for it in items])
            for k in items[0]}


def shuffle_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s shuffle generator under run seed `seed`."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


@contextlib.contextmanager
def ema_weights(model: torch.nn.Module, ema: Optional[list]):
    """Run the block with the EMA weights in the model (in place, so the
    parameters keep their addresses), then put the raw training weights
    back.  No EMA (``None``): the block runs with the model as it is."""
    if ema is None:
        yield
        return
    params = list(model.parameters())
    raw = [p.detach().clone() for p in params]
    with torch.no_grad():
        torch._foreach_copy_(params, ema)
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_(params, raw)


@torch.no_grad()
def restore_weights(model: torch.nn.Module, ema: Optional[list],
                    state: Dict[str, torch.Tensor]):
    """Copy a state_dict of `model` (the best weights) into the model's
    weights and, with EMA on, into the EMA list (aligned with
    ``model.parameters()``), in place: a captured step goes on reading and
    writing the same tensors."""
    for key, value in model.state_dict().items():
        value.copy_(state[key])
    if ema is not None:
        names = [name for name, _ in model.named_parameters()]
        torch._foreach_copy_(ema, [state[name] for name in names])


def _nbytes(data: Dict) -> int:
    return sum(v.nbytes for v in data.values() if v is not None)


class DeviceEpochRunner:
    """Runs `run_train`'s inner epoch with the data on the model's device
    and, on a CUDA device, each train step as a replay of one CUDA graph.

    Parameters mirror what `run_train` receives.  Construction puts both
    datasets on the device.  On a CUDA device the optimizer must be a
    `ClippedAdam` (`AdamOneCycle`, `AdamPlateau`), whose step values come
    from the device (a replayed step of another optimizer would repeat the
    captured ones).  ``mode`` ("min" or "max") is the direction in which
    `run_block` tracks the best validation metric.
    ``train_step.generators`` (see ``train.steps``) are registered with the
    graph, so that each replay draws fresh noise; dropout on the default
    generator is registered by ``torch.cuda.graph`` itself.  A
    ``train_step.before_step`` callable runs on the host before every train
    step, eager or replayed (the random-feature models redraw their ω into
    its buffers there).
    """

    def __init__(self, model: torch.nn.Module, train_step: Callable, eval_step: Callable,
                 optimizer: torch.optim.Optimizer, train_loader, valid_loader,
                 ema_decay: Optional[float] = None, shuffle_seed: Optional[int] = None,
                 epochs_per_dispatch: int = 1, mode: str = "min", verbose: bool = True):
        if getattr(train_loader, "num_shards", 1) != 1 or \
                getattr(train_step, "mesh", None) is not None:
            raise ValueError(
                "DeviceEpochRunner is single-process; use the host "
                "DataLoader path for multi-host sharded input")
        self.model, self.optimizer = model, optimizer
        self.train_step, self.eval_step = train_step, eval_step
        self.device = next(model.parameters()).device
        self.graphed = self.device.type == "cuda"
        if self.graphed and not isinstance(optimizer, ClippedAdam):
            raise TypeError(f"a captured train step needs an AdamOneCycle or AdamPlateau "
                            f"optimizer (step values read on the device), got "
                            f"{type(optimizer).__name__}")
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.batch_size = train_loader.batch_size
        self.shuffle = bool(getattr(train_loader, "shuffle", False))
        self.ema_decay = ema_decay
        self.epochs_per_dispatch = max(1, int(epochs_per_dispatch))

        with span("gt.loop.stack"):
            train_np = stack_dataset(train_loader.dataset)
            valid_np = stack_dataset(valid_loader.dataset)
        self.n_train = len(train_loader.dataset)
        self.n_batches = self.n_train // self.batch_size
        if verbose:
            gb = (_nbytes(train_np) + _nbytes(valid_np)) / 2 ** 30
            k = self.epochs_per_dispatch
            per = "1 host read/epoch" if k == 1 else f"1 host read per {k} epochs"
            step = "CUDA graph replays" if self.graphed else "eager steps"
            print(f"device-resident data: {self.n_train} train / "
                  f"{len(valid_loader.dataset)} valid samples "
                  f"({gb:.2f} GiB on {self.device}), {self.n_batches} steps/epoch "
                  f"({step}), {per}")
        rem = self.n_train - self.n_batches * self.batch_size
        if rem and not getattr(train_loader, "drop_last", True):
            # the captured step needs static batch shapes; silently training
            # on fewer samples than the host loop would is a footgun
            raise ValueError(
                f"device epoch loop requires drop_last=True when the train "
                f"set is ragged ({self.n_train} % {self.batch_size} = {rem} "
                f"samples would be dropped); pass drop_last=True to the "
                f"DataLoader or use the host loop (--no-device-data)")
        if self.n_batches == 0:
            raise ValueError(f"the train set ({self.n_train} samples) holds no batch of "
                             f"{self.batch_size}")
        # pre-batch the validation set: full batches + optional ragged tail
        vbs = valid_loader.batch_size
        n_valid = len(valid_loader.dataset)
        n_full = n_valid // vbs
        with span("gt.loop.to_device"):
            self.train_data = self._on_device(train_np)
            self.valid_full = self._on_device(
                {k: None if v is None else v[: n_full * vbs].reshape((n_full, vbs) + v.shape[1:])
                 for k, v in valid_np.items()}) if n_full else None
            self.valid_tail = (self._on_device({k: None if v is None else v[n_full * vbs:]
                                                for k, v in valid_np.items()})
                               if n_valid % vbs else None)
        self._valid_counts = (n_full, n_full * vbs, n_valid % vbs)

        # follow the DataLoader's seed (the driver's --seed) so device- and
        # host-loop runs draw from the same run-identity, not a fixed const
        self.seed = getattr(train_loader, "seed", 1127802) if shuffle_seed is None \
            else shuffle_seed
        self.params = list(model.parameters())
        self.ema = ([p.detach().clone() for p in self.params]
                    if ema_decay is not None else None)

        # the steps' device state: the epoch's batches of sample ids, the
        # step index in the epoch, the batch buffers and the losses buffer;
        # the validation batch index, its batch buffers and its metrics
        dev = self.device
        self._ids = torch.zeros((self.n_batches, self.batch_size), dtype=torch.int64,
                                device=dev)
        self._index = torch.zeros(1, dtype=torch.int64, device=dev)
        self._batch = {k: None if v is None else
                       torch.empty((self.batch_size,) + v.shape[1:], dtype=v.dtype, device=dev)
                       for k, v in self.train_data.items()}
        self._losses = None            # (n_batches, n_losses), made by the first step
        self._vindex = torch.zeros(1, dtype=torch.int64, device=dev)
        self._vbatch = ({k: None if v is None else torch.empty((1,) + v.shape[1:],
                                                               dtype=v.dtype, device=dev)
                         for k, v in self.valid_full.items()} if n_full else None)
        self._metrics = torch.zeros(n_full, dtype=torch.float32, device=dev)
        stream = torch.cuda.Stream(dev) if self.graphed else None
        self._train = Replayed(self._step, stream, WARMUP_STEPS,
                                getattr(train_step, "generators", ()), name="train_step")
        self._eval = Replayed(self._eval_step, stream, EVAL_WARMUP_STEPS, name="eval_step")

    @property
    def eager_steps(self) -> int:
        """Train steps run eagerly (every one on the CPU, the warm-up on CUDA)."""
        return self._train.eager

    @property
    def replays(self) -> int:
        """Replays of the captured train step."""
        return self._train.replays

    def kernels(self) -> list:
        """The (mangled) names of the device kernels that each replay of the
        captured train step launches (``ops/cuda/_graph.py``); [] before the
        capture."""
        return self._train.kernels()

    def replayed(self) -> list:
        """(kernel names, replays) of each captured step, train and eval:
        every replay launches each of its graph's kernels once."""
        return [(r.kernels(), r.replays) for r in (self._train, self._eval)]

    def _on_device(self, data: Dict) -> Dict:
        return {k: None if v is None else torch.as_tensor(v, device=self.device)
                for k, v in data.items()}

    # ---------------------------------------------------------------- steps

    def _step(self):
        """One train step on the device state: gather, step, EMA, losses."""
        ids = self._ids.index_select(0, self._index).view(-1)
        for k, v in self.train_data.items():
            if v is not None:
                torch.index_select(v, 0, ids, out=self._batch[k])
        losses = torch.stack(self.train_step(self._batch))
        if self.ema is not None:
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, [p.detach() for p in self.params],
                                alpha=1.0 - self.ema_decay)
        if self._losses is None:
            self._losses = torch.empty((self.n_batches, losses.numel()), dtype=losses.dtype,
                                       device=self.device)
        self._losses.index_copy_(0, self._index, losses[None])
        self._index.add_(1)

    def _eval_step(self):
        """One validation step on the device state: the full batch at the
        batch index, its metric into the metrics buffer."""
        for k, v in self.valid_full.items():
            if v is not None:
                torch.index_select(v, 0, self._vindex, out=self._vbatch[k])
        metric = self.eval_step({k: None if b is None else b[0]
                                 for k, b in self._vbatch.items()})
        self._metrics.index_copy_(0, self._vindex, metric.float().view(1))
        self._vindex.add_(1)

    def train_epoch(self, epoch_idx: int) -> torch.Tensor:
        """The train steps of epoch `epoch_idx`: its shuffle, then one step
        per batch.  Returns the device buffer of the per-step losses,
        (n_batches, n_losses), which the next epoch overwrites."""
        with span("gt.loop.shuffle"):
            if self.shuffle:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(shuffle_seed(self.seed, epoch_idx))
                perm = torch.randperm(self.n_train, generator=gen, device=self.device)
            else:
                perm = torch.arange(self.n_train, device=self.device)
            self._ids.copy_(perm[: self.n_batches * self.batch_size].view(self._ids.shape))
            self._index.zero_()
        count = getattr(self.optimizer, "count", None)
        before = getattr(self.train_step, "before_step", None)
        with span("gt.loop.train"):
            for _ in range(self.n_batches):
                if before is not None:
                    before()
                self._train()
        if self.graphed:   # the capture moved the host count, the replays did not
            self.optimizer.count = count + self.n_batches
        return self._losses

    def validate(self) -> torch.Tensor:
        """The batch-size-weighted mean of ``eval_step`` over the validation
        set, a 0-d device tensor, with the EMA weights in the model when EMA
        is on.  The full batches run as the captured eval step (on the
        CPU eagerly), the ragged tail eagerly."""
        n_full, n_full_samples, n_tail = self._valid_counts
        total = None
        with span("gt.loop.validate"), ema_weights(self.model, self.ema):
            if self.valid_full is not None:
                self._vindex.zero_()
                for _ in range(n_full):
                    self._eval()
                total = self._metrics.sum() * (n_full_samples / n_full)
            if self.valid_tail is not None:
                tail = self.eval_step(self.valid_tail) * n_tail
                total = tail if total is None else total + tail
        return total / (n_full_samples + n_tail)

    # ---------------------------------------------------------------- epochs

    def epoch(self, epoch_idx: int):
        """One epoch on the device.  Returns (losses [np, (n_batches,
        n_losses)], val_metric [float]), read from the device at once."""
        with span("gt.loop.epoch"):
            losses = self.train_epoch(epoch_idx)
            val = self.validate()
            with span("gt.loop.host_read"):
                host = torch.cat([losses.flatten().float(), val.float().view(1)]).cpu().numpy()
        return host[:-1].reshape(losses.shape), float(host[-1])

    def run_block(self, best_val: float, best_params: Dict[str, torch.Tensor],
                  start_epoch: int, k: int):
        """Run epochs [start_epoch, start_epoch+k) with one host read.

        Best-val tracking runs on the device: after each epoch,
        ``isfinite(val) & (val < best)`` (``val > best`` with ``mode="max"``)
        replaces the best value and copies
        the evaluated parameters (the EMA average with EMA on) into
        `best_params`, a state_dict of the model on its device that is
        updated in place (pass a snapshot, not the live weights): the exact
        best-epoch parameters without a host read per epoch.

        Returns (best_val [float], best_params, losses [np, (k, n_batches,
        n_losses)], vals [np, (k,)]).
        """
        best = torch.full((), best_val, dtype=torch.float32, device=self.device)
        losses, vals = [], []
        last = start_epoch + k - 1
        for epoch in range(start_epoch, last + 1):
            with span("gt.loop.epoch"):
                losses.append(self.train_epoch(epoch).clone())
                val = self.validate().float()
                vals.append(val)
                better = torch.isfinite(val) & (val > best if self.mode == "max" else val < best)
                best = torch.where(better, val, best)
                with ema_weights(self.model, self.ema), torch.no_grad():
                    for key, value in self.model.state_dict().items():
                        best_params[key].copy_(torch.where(better, value, best_params[key]))
                if epoch == last:   # the block's one host read closes its last epoch
                    with span("gt.loop.host_read"):
                        losses = torch.stack(losses)
                        host = torch.cat([losses.flatten().float(), torch.stack(vals),
                                          best.view(1)]).cpu().numpy()
        n = losses.numel()
        return (float(host[-1]), best_params, host[:n].reshape(losses.shape),
                host[n:-1])
