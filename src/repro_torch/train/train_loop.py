"""Training loop: the train-step factory and the loop that runs it.

Counterpart of the JAX package's ``train/train_loop.py``.  The step is the
same function: the model's forward (``remat`` recomputes each layer group's
activations in the backward), cross-entropy with z-loss plus the MoE aux
loss, the gradients by autograd, and the reference's AdamW (on the card
the AdamW kernel).  As the JAX trainer jits the step, ``train`` captures it
on the card as one CUDA graph at the first step and replays it for every
later one (``train.step_graph.TrainGraph``); a failed capture raises.  On
the CPU the same step runs eagerly.  ``train`` runs on the card unless
asked for the CPU, and raises when it finds no card; it never carries on on
the CPU.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.losses import cross_entropy
from repro_torch.train.optimizer import AdamWConfig, AdamWState, apply_updates, init_state
from repro_torch.train.step_graph import TrainGraph


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    remat: bool = True, **forward_options) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The parameters must require grad; they and the optimizer's
    moments are updated in place.  The metrics are () tensors on the
    parameters' device: the loss's ``loss``, ``nll``, ``ppl_proxy`` and
    ``tokens``, ``moe_aux``, ``grad_norm`` and ``lr``.  ``forward_options``
    go to ``transformer.forward`` (the dry run's)."""

    def train_step(params, opt_state: AdamWState, batch):
        logits, aux = T.forward(params, cfg, batch, remat=remat, **forward_options)
        m = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        del logits
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(m["loss"] + aux, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
        grad_tree = _unflatten_like(params, grads)
        params, opt_state, om = apply_updates(opt_cfg, params, grad_tree, opt_state)
        metrics = {**{k: v.detach() for k, v in m.items()}, "moe_aux": aux.detach(), **om}
        return params, opt_state, metrics

    return train_step


def _unflatten_like(tree, leaves: Iterator[torch.Tensor]):
    """A tree of ``tree``'s structure whose tensors are taken in turn from
    ``leaves``, in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        filled = {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, tuple):
        return tuple(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


def train(cfg: ArchConfig, batches: Iterator[Dict], steps: int,
          opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
          log_every: int = 10, checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0, device="cuda") -> Dict:
    """Train ``cfg`` from random weights drawn by ``torch.Generator`` seeded
    with ``seed`` on ``device`` for ``steps`` steps of ``batches`` (numpy
    dicts of ``tokens`` and ``labels``).  On the card the first step is
    captured and every later one replays it.  Returns {"params",
    "opt_state", "history"}, the history's entries holding the step's
    metrics as floats with ``step`` and ``elapsed_s``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to train on the CPU")
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    params = tree_map(lambda p: p.requires_grad_(True), params)
    opt_state = init_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    graph = None
    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(batches).items()}
        if device.type != "cuda":
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        elif graph is None:
            graph = TrainGraph(step_fn, params, opt_state, batch)
            metrics = graph.first_metrics
        else:
            metrics = graph.replay(batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            print(f"step {step:5d} loss={m['loss']:.4f} nll={m['nll']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            from repro_torch.train.checkpoint import save
            save(checkpoint_path, params, opt_state, step=step + 1)
    return {"params": params, "opt_state": opt_state, "history": history}
