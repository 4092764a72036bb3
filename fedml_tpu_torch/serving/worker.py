"""Inference replica worker: one process (or in-process object) a replica.

The port of ``fedml_tpu/serving/worker.py``.  Loads a model-hub model and a
pytree-wire parameter file (flax layout, the reference's artifact) and
serves predict / ready over HTTP (``serving/inference.py``) through the
continuous micro-batcher (``serving/batcher.py``), on ``device``: the card
unless ``--device`` names another (the tests pass ``cpu``).

- requests coalesce into the fixed padded batch (bounded admission, 503 +
  Retry-After on overflow);
- with ``--publish-dir`` the worker polls the training server's
  publication manifest (``serving/publisher.py``) and hot-swaps the
  variables between micro-batches: zero dropped in-flight requests,
  optional canary-fraction routing with auto-rollback on a health
  regression;
- ``--feature-dim`` names the input feature shape (``32`` for LR/MLP,
  ``32,32,3`` for conv models) so the warm-up runs before ``/ready`` even
  when the shape is not inferable from the parameter tree.

The model is built as the reference builds it, ``Config(model=...,
dataset="synthetic")`` without ``fused_blocks``: a replica serves the
unfused net (the default compute dtype, bf16).  ``--aot-dir`` and
``--flight-dir`` (the AOT program store, the flight recorder) are not
ported (``ROADMAP.md`` Queue 1 item 10b) and raise.

Usage: python -m fedml_tpu_torch.serving.worker --model resnet20 --classes 10 \
           --params /path/params.wire --port 2500 [--feature-dim 32,32,3] \
           [--publish-dir /path/pub] [--canary-fraction 0.1] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
from typing import Optional

log = logging.getLogger("fedml_tpu_torch.serving.worker")

#: why the flight recorder is refused
FLIGHT_REFUSAL = ("the flight recorder (the reference's obs/flight.py) is not ported yet "
                  "(ROADMAP.md Queue 1 item 10b)")


def load_params(path: str):
    """A published or saved artifact: the wire tree (numpy, flax layout)."""
    from ..comm import wire

    with open(path, "rb") as f:
        return wire.decode_pytree(f.read())


def port_variables(tree):
    """An artifact's flax-layout tree as the port's layout (numpy)."""
    from .. import weights

    return weights.flax_to_torch(tree)


def parse_feature_dim(spec: Optional[str]):
    """``"32"`` -> ``(32,)``; ``"32,32,3"`` -> ``(32, 32, 3)``; None/""
    -> None (fall back to :func:`_infer_feature_shape`)."""
    if not spec:
        return None
    return tuple(int(d) for d in str(spec).split(",") if str(d).strip())


def build_model(model_name: str, classes: int, feature_shape):
    """The replica's model, as the reference's worker builds it (no
    ``fused_blocks``); ``feature_shape`` sizes the first dense layer of the
    regression and the MLP, which the port builds with their widths."""
    import math

    from ..arguments import Config
    from ..models import model_hub

    cfg = Config(model=model_name, dataset="synthetic")
    shape = tuple(feature_shape or ())
    return model_hub.create(cfg, int(classes), in_features=math.prod(shape) if shape else 0,
                            input_shape=shape)


class ServingWorker:
    """One serving replica as a library object: model + batcher + HTTP
    runner + (optional) manifest watcher / hot swap / canary.  The CLI
    ``main`` below drives this class; tests use it in-process."""

    def __init__(self, model_name: str, classes: int, *,
                 params=None, params_path: Optional[str] = None,
                 publish_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 32, max_queue: int = 256,
                 flush_ms: float = 2.0, canary_fraction: float = 0.0,
                 canary_min_batches: int = 8, poll_s: float = 0.05,
                 feature_shape=None, aot_dir: Optional[str] = None,
                 bootstrap_timeout_s: float = 60.0,
                 flight_dir: Optional[str] = None,
                 eval_batch=None, device=None):
        from ..core.device import resolve_device
        from .batcher import MicroBatcher
        from .inference import AOT_REFUSAL, FedMLInferenceRunner, TorchPredictor
        from .publisher import HotSwapController, ManifestWatcher, watch_and_swap

        if aot_dir:
            raise NotImplementedError(AOT_REFUSAL)
        if flight_dir:
            raise NotImplementedError(FLIGHT_REFUSAL)
        self.device = resolve_device(device)
        self.publish_dir = publish_dir
        self._watcher: Optional[ManifestWatcher] = None
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None

        version = 0
        if params is None and params_path:
            params = load_params(params_path)
        if params is None:
            if not publish_dir:
                raise ValueError(
                    "worker needs --params or --publish-dir (manifest bootstrap)")
            # bootstrap from the publication manifest: serve the first
            # published version without any local artifact
            boot = ManifestWatcher(publish_dir)
            got = boot.wait_for_version(0, timeout_s=bootstrap_timeout_s,
                                        poll_s=min(0.05, poll_s))
            if got is None:
                raise TimeoutError(
                    f"no model published under {publish_dir} within "
                    f"{bootstrap_timeout_s}s")
            version, path, _manifest = got
            params = load_params(path)
            self._watcher = boot
        elif publish_dir:
            self._watcher = ManifestWatcher(publish_dir, last_version=version)

        if feature_shape is None:
            feature_shape = _infer_feature_shape(params)
        self.model = build_model(model_name, classes, feature_shape)
        self.predictor = TorchPredictor(
            self.model, port_variables(params), max_batch=max_batch,
            feature_shape=feature_shape, model_name=model_name, device=self.device)
        # warm up BEFORE serving: readiness means "can answer now", and the
        # first forward pays cuDNN's and the allocator's first use
        self.predictor.warm()
        # optional labeled eval batch (x, y): canaries are scored on real
        # held-out accuracy before promotion (HotSwapController)
        self.swap = HotSwapController(
            self.predictor, version=version,
            canary_fraction=canary_fraction,
            canary_min_batches=canary_min_batches,
            eval_batch=eval_batch)
        self.batcher = MicroBatcher(
            self.predictor, controller=self.swap, max_batch=max_batch,
            max_queue=max_queue, flush_ms=flush_ms)
        self.runner = FedMLInferenceRunner(
            self.predictor, host=host, port=port, batcher=self.batcher,
            stats_fn=self.stats)
        if self._watcher is not None:
            self._watch_thread = watch_and_swap(
                self._watcher, self.swap, self._load_version, self._stop,
                poll_s=poll_s)

    # -- hot swap -------------------------------------------------------------
    def _load_version(self, version: int, path: str, _manifest: dict):
        """Decode, move and warm a published tree OFF the serving path (the
        old tree serves until this returns): the zero-drop half of the hot
        swap."""
        pred = self.predictor.clone_with(port_variables(load_params(path)))
        pred.warm()
        return pred

    # -- lifecycle ------------------------------------------------------------
    def start(self, block: bool = False) -> int:
        """Serve; returns the bound port (non-blocking mode)."""
        return self.runner.run(block=block)

    def stop(self) -> None:
        self._stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5.0)
        self.batcher.stop()
        self.runner.stop()

    def stats(self) -> dict:
        return {**self.batcher.stats(), **self.swap.stats()}

    @property
    def served_version(self) -> int:
        return self.swap.version


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--params", default=None,
                    help="pytree-wire params file (optional with --publish-dir)")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission queue bound (full queue -> 503 + Retry-After)")
    ap.add_argument("--flush-ms", type=float, default=2.0,
                    help="partial micro-batch flush deadline (0 = immediate)")
    ap.add_argument("--feature-dim", default=None,
                    help="input feature shape, comma-separated (e.g. 32 or "
                         "32,32,3): overrides inference from the parameter "
                         "tree so conv models warm up before /ready too")
    ap.add_argument("--publish-dir", default=None,
                    help="training server's model publication dir: poll the "
                         "manifest and hot-swap new versions with zero "
                         "dropped requests")
    ap.add_argument("--poll-s", type=float, default=0.25,
                    help="manifest poll interval")
    ap.add_argument("--canary-fraction", type=float, default=0.0,
                    help="fraction of micro-batches routed to a freshly "
                         "published version before promotion (0 = direct "
                         "swap); regressions auto-roll-back")
    ap.add_argument("--canary-min-batches", type=int, default=8)
    ap.add_argument("--aot-dir", default=None,
                    help="the reference's AOT program store (not ported: raises)")
    ap.add_argument("--flight-dir", default=None,
                    help="the reference's flight recorder (not ported: raises)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[serving worker] %(asctime)s %(levelname)s %(message)s")

    worker = ServingWorker(
        args.model, args.classes, params_path=args.params,
        publish_dir=args.publish_dir, host=args.host, port=args.port,
        max_batch=args.max_batch, max_queue=args.max_queue,
        flush_ms=args.flush_ms, canary_fraction=args.canary_fraction,
        canary_min_batches=args.canary_min_batches, poll_s=args.poll_s,
        feature_shape=parse_feature_dim(args.feature_dim),
        aot_dir=args.aot_dir, flight_dir=args.flight_dir, device=args.device)
    log.info("serving %s on %s, port %d", args.model, worker.device, args.port)
    worker.start(block=True)
    return 0


def _infer_feature_shape(variables):
    """Best-effort input shape from the first 2-D kernel leaf of a flax-
    layout tree (LR/MLP: (d, c) -> (d,)); None when unknown (conv models
    need ``--feature-dim`` to warm up before serving)."""
    import numpy as np

    def walk(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "kernel" and getattr(v, "ndim", 0) == 2:
                    return (int(np.asarray(v).shape[0]),)
                got = walk(v)
                if got is not None:
                    return got
        return None

    return walk(variables)


if __name__ == "__main__":
    sys.exit(main())
