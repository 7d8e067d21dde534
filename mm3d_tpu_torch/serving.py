"""HTTP serving of exported artifacts (counterpart of ``mm3d_tpu/serving.py``).

The deployment tail of the port's serving story:

    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.training.inference import export_serving, save_serving
    pred = make_predictor(name, state, dtype=torch.bfloat16, device="cuda")
    save_serving("model.pt2", export_serving(pred, example_inputs))

    python -m mm3d_tpu_torch.serving --artifact model.pt2 --port 8765

The daemon needs only torch, numpy, ``mm3d_tpu_torch.ops`` (which registers
the ``mm3d::*`` kernel operators an artifact's graph calls) and the
artifact: no model code and no checkpoint (the weights are inside the
artifact). An artifact is a ``torch.export`` archive
(``torch.export.save``) of the eval forward's log-probs, plus one JSON file
in the archive (``ARTIFACT_META``) that records the device type it was
exported on and its input signature. It serves only on that device type.

Protocol (numpy ``.npz`` bodies), the JAX package's:

* ``POST /predict`` -- body: npz with one array per model input, keys
  ``arg0..argN`` (cls: ``arg0`` = points [B,N,3]; part-seg adds ``arg1`` =
  one-hot categories; fusion: points, image, K, R, t). Response: npz with
  ``log_probs``. Any request batch size works: fixed-batch artifacts are
  padded and chunked here, batch-polymorphic ones are called directly.
  400 for a malformed body or a shape the artifact does not take, 413 for
  a body over ``max_body_mb``, 500 when the forward fails (a kernel that
  does not build or launch, say).
* ``GET /spec`` -- the artifact's input signature and device type (JSON).
* ``GET /healthz`` -- liveness (JSON).
* ``GET /metrics`` -- request, error and cloud counters and latency
  percentiles over the last 1024 requests (JSON).

``PredictionService`` is the transport-free core (load, pad and chunk,
predict) for embedding into other servers.
"""

from __future__ import annotations

import io
import json
import threading
import time
import zipfile
from typing import List, Sequence

import numpy as np
import torch

from mm3d_tpu_torch import ops  # noqa: F401 -- registers the mm3d operators

# the archive member (``extra_files`` of torch.export.save) that holds the
# artifact's device type and input signature
ARTIFACT_META = "mm3d_serving.json"


def save_serving(path: str, exported: torch.export.ExportedProgram) -> None:
    """Save an ``export_serving`` result to one file: the exported program
    with its weights, and the device type and input signature it was
    exported with (a batch-polymorphic input's leading dimension is
    ``"b"``)."""
    names = exported.graph_signature.user_inputs
    vals = {n.name: n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder"}
    inputs = [{"shape": [d if isinstance(d, int) else "b"
                         for d in vals[n].shape],
               "dtype": str(vals[n].dtype).removeprefix("torch.")}
              for n in names]
    meta = {"device": vals[names[0]].device.type, "inputs": inputs}
    torch.export.save(exported, path,
                      extra_files={ARTIFACT_META: json.dumps(meta)})


def artifact_meta(path: str) -> dict:
    """The device type and input signature ``save_serving`` recorded, read
    without loading the program."""
    try:
        with zipfile.ZipFile(path) as z:
            member = [n for n in z.namelist()
                      if n.endswith(f"/extra/{ARTIFACT_META}")]
            if len(member) == 1:
                return json.loads(z.read(member[0]))
    except zipfile.BadZipFile:
        pass
    raise ValueError(f"{path} is not a serving artifact of mm3d_tpu_torch "
                     f"(no {ARTIFACT_META})")


def load_serving(path: str, device: str = "cuda") -> torch.nn.Module:
    """The artifact's program as a module: fn(*inputs) -> log_probs.

    ``device`` is the device type to serve on: it must be the one the
    artifact was exported on, and ``"cuda"`` raises where there is no card
    (no fallback to the CPU). A fixed-shape artifact refuses inputs of
    other shapes; a batch-polymorphic one takes any batch of 1 or more."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"serving on {device!r} requested but CUDA is not "
                           "available")
    meta = artifact_meta(path)
    if meta["device"] != dev.type:
        raise ValueError(f"{path} was exported on {meta['device']!r} and "
                         f"serves only there, not on {dev.type!r}: export it "
                         f"again on {dev.type!r}")
    return torch.export.load(path).module()


class PredictionService:
    """Loads one serving artifact; ``predict`` accepts any batch size.

    ``predict`` runs one request at a time (a lock): the kernels' host-side
    launchers keep process-wide caches without locks (the shared-memory
    size granted to a kernel in ``csrc/fused_fp.cu``, the occupancy cached
    in ``csrc/fused_sa.cu``), ``ctypes`` releases the interpreter lock
    during a launch, and the launch counters are read-modify-writes. The
    card runs the forwards one after another on its stream all the same."""

    def __init__(self, artifact_path: str, device: str = "cuda"):
        self._fn = load_serving(artifact_path, device)
        self.device = torch.device(device)
        self.inputs = artifact_meta(artifact_path)["inputs"]
        lead = self.inputs[0]["shape"][0]
        # int for fixed-batch artifacts, None for poly ones
        self.batch = lead if isinstance(lead, int) else None
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """One forward before the first request: builds the kernels (nvcc,
        at the first launch of each) on the daemon's clock, not a
        client's, and fails the start where a kernel does not build or
        launch. Poly artifacts warm at batch 1."""
        b = self.batch or 1
        self.predict(*[np.zeros((b,) + tuple(a["shape"][1:]),
                                np.dtype(a["dtype"])) for a in self.inputs])

    def spec(self) -> dict:
        return {
            "platforms": [self.device.type],
            "batch": self.batch or "poly",
            "inputs": [{"name": f"arg{i}", "shape": list(a["shape"]),
                        "dtype": a["dtype"]}
                       for i, a in enumerate(self.inputs)],
        }

    def _check(self, arrays: Sequence[np.ndarray]) -> None:
        if len(arrays) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs "
                             f"(arg0..arg{len(self.inputs) - 1}), "
                             f"got {len(arrays)}")
        b = arrays[0].shape[0] if arrays[0].ndim else -1
        for i, (x, a) in enumerate(zip(arrays, self.inputs)):
            want = tuple(a["shape"][1:])
            if x.ndim != len(a["shape"]) or tuple(x.shape[1:]) != want:
                raise ValueError(
                    f"arg{i}: expected shape [B, {', '.join(map(str, want))}]"
                    f", got {list(x.shape)}")
            if x.shape[0] != b:
                raise ValueError(f"arg{i}: batch {x.shape[0]} != arg0 "
                                 f"batch {b}")
        if b == 0:
            raise ValueError("empty batch")

    def _run(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        with torch.no_grad():
            out = self._fn(*[torch.from_numpy(x).to(self.device)
                             for x in arrays])
        return out.cpu().numpy()

    def predict(self, *arrays: np.ndarray) -> np.ndarray:
        """Run the artifact; pads and chunks to its fixed batch if needed."""
        # validate (arity included) BEFORE the dtype cast, which zips with
        # the inputs and would truncate a wrong arity
        arrays = [np.asarray(x) for x in arrays]
        self._check(arrays)
        arrays = [np.ascontiguousarray(x, dtype=np.dtype(a["dtype"]))
                  for x, a in zip(arrays, self.inputs)]
        b = arrays[0].shape[0]
        with self._lock:
            if self.batch is None or b == self.batch:
                return self._run(arrays)
            outs: List[np.ndarray] = []
            for lo in range(0, b, self.batch):
                chunk = [x[lo:lo + self.batch] for x in arrays]
                got = chunk[0].shape[0]
                if got < self.batch:  # wrap-pad the remainder (rows dropped)
                    chunk = [np.concatenate(
                        [c, np.repeat(c[:1], self.batch - got, axis=0)], 0)
                        for c in chunk]
                outs.append(self._run(chunk)[:got])
            return np.concatenate(outs, axis=0)


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _Metrics:
    """Thread-safe /predict counters and latency percentiles (last 1024)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        self.clouds_total = 0
        self._lat: List[float] = []

    def observe(self, ok: bool, batch: int, seconds: float) -> None:
        with self._lock:
            self.requests_total += 1
            if ok:
                self.clouds_total += batch
            else:
                self.errors_total += 1
            self._lat.append(seconds)
            if len(self._lat) > 1024:
                del self._lat[:-1024]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {"requests_total": self.requests_total,
                   "errors_total": self.errors_total,
                   "clouds_total": self.clouds_total}

        def pct(p):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 6)

        out["latency_s"] = {"p50": pct(0.50), "p90": pct(0.90),
                            "p99": pct(0.99)}
        return out


def make_server(service: PredictionService, host: str = "127.0.0.1",
                port: int = 0, quiet: bool = True,
                max_body_mb: float = 256.0):
    """An unstarted ThreadingHTTPServer bound to (host, port); port 0 picks
    a free one (``server.server_address[1]``). ``max_body_mb`` bounds
    /predict bodies (413 beyond it, the body drained unread) so one
    oversized npz cannot exhaust the host's memory. GET /metrics reports
    the counters (``server.metrics`` in the program)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    metrics = _Metrics()
    max_body = int(max_body_mb * (1 << 20))

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/spec":
                self._json(200, service.spec())
            elif self.path == "/metrics":
                self._json(200, metrics.snapshot())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            t0 = time.monotonic()

            def fail(code: int, msg: str):
                metrics.observe(False, 0, time.monotonic() - t0)
                self._json(code, {"error": msg})

            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n < 0:
                    raise ValueError(f"bad Content-Length {n}")
            except ValueError as e:  # malformed or negative header
                fail(400, str(e) or "bad Content-Length")
                return
            if n > max_body:
                # drain the body in small discarded chunks before the 413:
                # closing mid-upload would reach the client as a reset
                left = n
                while left > 0:
                    got = self.rfile.read(min(left, 1 << 16))
                    if not got:
                        break
                    left -= len(got)
                fail(413, f"request body {n} B > limit {max_body} B")
                return
            try:
                data = np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
                keys = sorted(data.files)
                want = [f"arg{i}" for i in range(len(service.inputs))]
                # compare as sets: a sorted list puts arg10 before arg2
                if keys != sorted(want):
                    raise ValueError(f"npz keys {keys} != expected {want}")
                arrays = [data[k] for k in want]
            except Exception as e:  # malformed request: body, npz or keys
                fail(400, str(e) or type(e).__name__)
                return
            try:
                log_probs = service.predict(*arrays)
            except ValueError as e:  # shape or batch validation
                fail(400, str(e))
                return
            except Exception as e:  # the forward failed: a kernel, say
                fail(500, str(e) or type(e).__name__)
                return
            body = _npz_bytes(log_probs=log_probs)
            metrics.observe(True, int(arrays[0].shape[0]),
                            time.monotonic() - t0)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        if quiet:
            def log_message(self, *a):  # noqa: D102 - stdlib signature
                pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.metrics = metrics
    return server


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="serve an exported mm3d_tpu_torch artifact over HTTP")
    p.add_argument("--artifact", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device type to serve on; it must be the one the "
                        "artifact was exported on (see /spec). 'cuda' "
                        "raises where there is no card")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the startup forward; the first /predict "
                        "request builds the kernels instead")
    p.add_argument("--max_body_mb", type=float, default=256.0,
                   help="reject /predict bodies over this size (413)")
    a = p.parse_args(argv)
    # fp32 artifacts are strict fp32 only with TF32 off: cuDNN convolutions
    # use TF32 by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False", flush=True)
    service = PredictionService(a.artifact, a.device)
    if not a.no_warmup:
        service.warmup()
    server = make_server(service, a.host, a.port, quiet=False,
                         max_body_mb=a.max_body_mb)
    print(f"serving {a.artifact} on http://{a.host}:"
          f"{server.server_address[1]}  spec={service.spec()}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
