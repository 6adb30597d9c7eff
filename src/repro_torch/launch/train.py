"""Training launcher: the in-graph CARLS training loop on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 3 --batch 2 --seq 16 --nodes 64

The default loop of ``repro.launch.train``, with its flags and its printed
lines: the reduced config of ``--arch`` (``--reduced`` is always on, as
there), random weights from ``--seed`` (a ``torch.Generator`` on the
device), a bank of ``--nodes`` rows of N(0, 0.01²) at width d_model, the
``SyntheticGraphCorpus`` of ``--nodes`` nodes, and per step: a neighbour
lookup through ``KBOps`` (on the card one launch of the fused-lookup
kernel), the loss (chunked cross-entropy + MoE aux + the graph regulariser
on the fetched rows), the gradient with respect to the parameters and the
rows, the rows' gradient pushed to the bank's lazy cache, the trainer's
push of its pooled sample embeddings, and AdamW (warmup-cosine from
``--lr``, weight decay 0.01). Every ``--maker-every`` steps an
embedding-refresh maker pass re-encodes ``--batch`` random nodes; with
``--ckpt-dir`` the parameters are saved as npz every ``--ckpt-every``
steps (the JAX package's layout; either package loads them).

``--makers KIND[,KIND...]`` switches to the asynchronous topology of the
JAX launcher's ``run_async``: the trainer and a ``MakerRuntime`` of the
named makers (``embedding_refresh``, ``label_mining``, ``graph_agreement``,
``graph_builder``; ``--maker-batch`` nodes a batch, paced by
``--maker-period`` seconds) as clients of one coalescing
``KnowledgeBankServer`` on ``--kb-backend`` (``cuda``, the kernels;
``dense``; ``sharded``), the trainer publishing a checkpoint every
``--ckpt-period`` steps:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --makers label_mining,graph_agreement --steps 4 --batch 4 --nodes 128

The run is on the CUDA device unless ``--device cpu`` is given. On the
card every ported arch trains: the flash, WKV and Mamba-scan kernels that
its forward reaches (attention over ``--seq`` >= 2048 tokens takes flash)
run under autograd through ``autograd.Function``s whose backwards are
kernels too.

``--kb-connect SPEC`` (with ``--makers``) trains against a bank in other
processes instead of an in-process server: ``host:port`` names one
``serve --kb --listen`` bank (of either package), a comma list a
partitioned fleet in ring order (``host:p0|host:s0,...`` attaches
standbys), dialed by ``repro_torch.core.connect_kb``; every trainer and
maker bank call then goes over the wire. The bank's width must be the
model's d_model:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --makers graph_builder --kb-connect 127.0.0.1:7787 --steps 4

``train_carls(cfg, ...)`` is the loop for any config of the ported archs,
the full-width one included; it returns the losses and each step's time.
``run_async(cfg, args, device)`` is the ``--makers`` mode for any config,
with the parser's ``args``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint import DiskCheckpointStore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.async_runtime import (format_maker_stats,
                                            run_async_training)
from repro_torch.core.kb_router import connect_kb
from repro_torch.core.knowledge_bank import kb_create
from repro_torch.core.knowledge_maker import make_embedding_refresh
from repro_torch.core.trainer import make_carls_train_step
from repro_torch.data import SyntheticGraphCorpus
from repro_torch.env import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.tree import tree_leaves


class CarlsLoop:
    """The state of one in-graph CARLS run and its step: the model, its
    parameters and AdamW state, the bank, the corpus and the batch
    stream. ``step()`` takes the next batch, runs one training step and,
    on their cadence, the maker pass and the checkpoint; it returns the
    step's metrics (tensors on the device)."""

    def __init__(self, cfg, *, steps: int, batch: int, seq: int, nodes: int,
                 lr: float, maker_every: int, ckpt_dir=None,
                 ckpt_every: int = 50, seed: int = 0, device="cuda"):
        self.dev = resolve_device(device)
        self.cfg = cfg.replace(carls=cfg.carls.__class__(
            **{**cfg.carls.__dict__, "kb_entries": nodes}))
        self.batch, self.nodes = batch, nodes
        self.maker_every, self.ckpt_every = maker_every, ckpt_every
        self.model = build_model(self.cfg)
        self.params = self.model.init(
            torch.Generator(device=self.dev).manual_seed(seed))
        self.opt = AdamW(lr=warmup_cosine(lr, steps // 10, steps),
                         weight_decay=0.01)
        self.opt_state = self.opt.init(self.params)
        self.kb = kb_create(nodes, self.cfg.d_model, device=self.dev,
                            generator=torch.Generator(
                                device=self.dev).manual_seed(1))
        self.corpus = SyntheticGraphCorpus(
            num_nodes=nodes, vocab_size=self.cfg.vocab_size,
            seq_len=seq + 1,
            neighbors_per_node=self.cfg.carls.num_neighbors)
        self.step_fn = make_carls_train_step(self.model, self.opt)
        self.maker_fn = make_embedding_refresh(self.model)
        self.ckpts = DiskCheckpointStore(ckpt_dir) if ckpt_dir else None
        self.rng = np.random.default_rng(seed + 1)
        self.done = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def num_params(self) -> int:
        return sum(p.numel() for p in tree_leaves(self.params))

    def step(self) -> Dict[str, torch.Tensor]:
        b = self.corpus.batch(self.rng, self.batch)
        tb = {k: self._tensor(v) for k, v in b.items()}
        self.params, self.opt_state, self.kb, m = self.step_fn(
            self.params, self.opt_state, self.kb, tb)
        self.done += 1
        if self.done % self.maker_every == 0:
            ids = self.rng.integers(0, self.nodes,
                                    self.batch).astype(np.int32)
            toks = self.corpus.node_tokens(ids)[:, :-1]
            self.kb = self.maker_fn(self.params, self.kb, self._tensor(ids),
                                    self._tensor(toks))
        if self.ckpts and self.done % self.ckpt_every == 0:
            self.ckpts.save(self.done, self.params)
        return m

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def train_carls(cfg, *, steps: int = 100, batch: int = 8, seq: int = 64,
                nodes: int = 2048, lr: float = 1e-3, maker_every: int = 10,
                ckpt_dir=None, ckpt_every: int = 50, seed: int = 0,
                device="cuda", log=print) -> Dict:
    """``steps`` in-graph CARLS steps of ``cfg`` (the JAX launcher's loop),
    printing its lines through ``log``. Returns {"losses": [float],
    "step_ms": [float] (host clock around each step, ending in a device
    sync), "metrics": the last step's, "loop": the ``CarlsLoop``, which
    can take more steps}."""
    loop = CarlsLoop(cfg, steps=steps, batch=batch, seq=seq, nodes=nodes,
                     lr=lr, maker_every=maker_every, ckpt_dir=ckpt_dir,
                     ckpt_every=ckpt_every, seed=seed, device=device)
    log(f"actual params: {loop.num_params()/1e6:.1f}M")
    losses: List[float] = []
    step_ms: List[float] = []
    m: Dict = {}
    loop.sync()
    t0 = time.perf_counter()
    for step in range(steps):
        ts = time.perf_counter()
        m = loop.step()
        loop.sync()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(m["loss"]))
        if step < 3 or (step + 1) % 10 == 0:
            log(f"step {step+1:5d} loss={losses[-1]:.4f} "
                f"acc={float(m['acc']):.3f} "
                f"reg={float(m['graph_reg']):.4f}"
                f" gnorm={float(m['grad_norm']):.2f}")
    dt = time.perf_counter() - t0
    log(f"done: {steps} steps in {dt:.1f}s "
        f"({dt/max(steps, 1)*1e3:.0f} ms/step)")
    return {"losses": losses, "step_ms": step_ms, "metrics": m,
            "loop": loop}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--maker-every", type=int, default=10)
    ap.add_argument("--makers", default="",
                    help="comma list of async maker kinds (embedding_refresh"
                         ",label_mining,graph_agreement,graph_builder); "
                         "non-empty switches to the async trainer+"
                         "MakerRuntime topology over one coalescing server")
    ap.add_argument("--maker-batch", type=int, default=64)
    ap.add_argument("--maker-period", type=float, default=0.0,
                    help="per-maker pacing floor in seconds")
    ap.add_argument("--ckpt-period", type=int, default=5,
                    help="async mode: trainer steps between checkpoint "
                         "publishes (the data-freshness axis)")
    ap.add_argument("--kb-backend", choices=["cuda", "dense", "sharded"],
                    default="cuda", help="async mode: bank engine backend")
    ap.add_argument("--kb-connect", default="",
                    metavar="HOST:PORT[,HOST:PORT,...]",
                    help="async mode: train against the bank served at "
                         "this endpoint (serve --kb --listen), or a "
                         "partitioned fleet in ring order, instead of an "
                         "in-process server")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.kb_connect and not args.makers:
        # as in JAX: the in-graph loop owns its bank and never talks to a
        # server, so a remote bank is refused rather than ignored
        ap.error("--kb-connect requires the async topology: pass --makers "
                 "(e.g. --makers graph_builder)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model,
                          head_dim=args.d_model // cfg.num_heads or 32)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(reduced={args.reduced})")
    if args.makers:
        return run_async(cfg, args, device)
    return train_carls(cfg, steps=args.steps, batch=args.batch,
                       seq=args.seq, nodes=args.nodes, lr=args.lr,
                       maker_every=args.maker_every, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       device=device,
                       log=lambda line: print(line, flush=True))


def run_async(cfg, args, device) -> Dict:
    """``--makers``: the trainer and a ``MakerRuntime`` concurrently
    against one coalescing ``KnowledgeBankServer`` (the paper's Figure-1
    triangle), or against the bank at ``--kb-connect``, with the JAX
    launcher's corpus and lines. Returns {"result": the
    ``AsyncRunResult``, "seconds": the run's wall time}."""
    makers = [m.strip() for m in args.makers.split(",") if m.strip()]
    cfg = cfg.replace(carls=cfg.carls.__class__(
        **{**cfg.carls.__dict__, "kb_entries": args.nodes}))
    corpus = SyntheticGraphCorpus(
        num_nodes=args.nodes, vocab_size=cfg.vocab_size,
        seq_len=args.seq + 1, neighbors_per_node=cfg.carls.num_neighbors,
        num_clusters=4, labeled_frac=0.3, label_noise=0.3,
        seed=args.seed)
    kb_client = None
    if args.kb_connect:
        kb_client = connect_kb(args.kb_connect, client_name="trainer")
        parts = getattr(kb_client, "pmap", None)
        shape = f"{parts.num_partitions} partitions, " if parts else ""
        print(f"async CARLS: trainer + makers {makers} over the wire "
              f"(bank at {args.kb_connect}: {shape}"
              f"{kb_client.num_entries}x{kb_client.dim})", flush=True)
    else:
        print(f"async CARLS: trainer + makers {makers} "
              f"(kb backend: {args.kb_backend})", flush=True)
    t0 = time.perf_counter()
    try:
        res = run_async_training(
            build_model(cfg), corpus, steps=args.steps,
            batch_size=args.batch, makers=makers,
            maker_batch=args.maker_batch, maker_period_s=args.maker_period,
            ckpt_period=args.ckpt_period, lr=args.lr, trainer_push=True,
            kb_backend=args.kb_backend, kb_client=kb_client, seed=args.seed,
            device=device)
    except BaseException:
        if kb_client is not None:
            kb_client.close()
        raise
    dt = time.perf_counter() - t0
    print(f"loss {res.losses[0]:.4f} -> {np.mean(res.losses[-5:]):.4f} "
          f"over {args.steps} steps in {dt:.1f}s; "
          f"mean row staleness {res.mean_staleness:.2f} trainer steps")
    m = res.server.metrics
    print(f"kb server: {m['requests']} requests -> {m['dispatches']} "
          f"dispatches (coalescing x{res.server.coalescing_factor:.1f})")
    if kb_client is not None:
        t = res.server.stats().get("transport", {})
        if t:
            print(f"kb transport: reconnects={t.get('reconnects', 0)} "
                  f"reissued={t.get('reissued', 0)}")
    for line in format_maker_stats(res.server.maker_stats):
        print(line)
    return {"result": res, "seconds": dt}


if __name__ == "__main__":
    main()
