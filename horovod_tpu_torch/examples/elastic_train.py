#!/usr/bin/env python
"""Elastic training: the twin of the JAX package's
``examples/elastic_train.py``, with the same data, model and flags.

A linear regression (256 samples of 16 features, seed 0) trained with SGD
at 0.05 under ``hvd.elastic.run``: :class:`TorchState` commits the model,
the optimizer and an :class:`ElasticSampler` after every step, and a world
that grows or shrinks goes on from the last commit, the sampler
repartitioning the rest of the epoch. Each rank's per-step loss (the mean
over its own batch) is kept in the state. Runs on the card unless
``--device cpu`` is given::

    python -m horovod_tpu_torch.examples.elastic_train --smoke --device cpu
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \\
        --host-discovery-script ./discover.sh -- \\
        python -m horovod_tpu_torch.examples.elastic_train
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd

N_SAMPLES, N_FEATURES = 256, 16


def make_data(seed: int = 0):
    """The JAX example's data: ``x`` (256, 16), ``y = x @ w_true``."""
    rng = np.random.default_rng(seed)
    data_x = rng.standard_normal((N_SAMPLES, N_FEATURES)).astype(np.float32)
    true_w = rng.standard_normal((N_FEATURES, 1)).astype(np.float32)
    return data_x, data_x @ true_w


def make_state(device):
    """The model (``w``, zeros), ``DistributedOptimizer(SGD(0.05))``, the
    sampler and the elastic state holding them."""
    model = torch.nn.Linear(N_FEATURES, 1, bias=False).to(device)
    with torch.no_grad():
        model.weight.zero_()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())
    sampler = hvd.elastic.ElasticSampler(N_SAMPLES, seed=1)
    state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                   sampler=sampler, epoch=0, step=0,
                                   losses=[])
    # a world that changed repartitions the rest of the epoch
    state.register_reset_callbacks(
        [lambda: sampler.load_state_dict(sampler.state_dict())])
    return state


def make_train(epochs: int, batch_per_rank: int, data, hook=None):
    """The elastic training function of ``state``; ``hook(state)``, where
    given, runs after each commit (tests schedule world changes there)."""
    data_x, data_y = data

    @hvd.elastic.run
    def train(state):
        model, opt, sampler = state.model, state.optimizer, state.sampler
        device = next(model.parameters()).device
        for state.epoch in range(state.epoch, epochs):
            idx_all = sampler.local_indices()
            for start in range(0, len(idx_all) - batch_per_rank + 1,
                               batch_per_rank):
                local = idx_all[start:start + batch_per_rank]
                x = torch.from_numpy(data_x[local]).to(device)
                y = torch.from_numpy(data_y[local]).to(device)
                opt.zero_grad()
                loss = ((model(x) - y) ** 2).mean()
                loss.backward()
                opt.step()
                sampler.record_batch(batch_per_rank)
                state.losses = state.losses + [float(loss.detach())]
                state.step += 1
                state.commit()
                if hook is not None:
                    hook(state)
            sampler.set_epoch(state.epoch + 1)
            if hvd.rank() == 0:
                print(f"epoch {state.epoch}: loss={state.losses[-1]:.5f}",
                      flush=True)
        return state.losses

    return train


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-per-rank", type=int, default=8)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cpu for a gloo world on the host (default: "
                             "the card)")
    args = parser.parse_args(argv)
    if args.smoke:
        args.epochs = 2

    hvd.init(device=args.device)
    state = make_state(hvd.runtime.device())
    losses = make_train(args.epochs, args.batch_per_rank, make_data())(state)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    if hvd.rank() == 0:
        print("OK", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
