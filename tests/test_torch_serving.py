"""The port's serving artifacts and HTTP daemon against the JAX package's, on
the CPU.

``export_serving`` / ``save_serving`` / ``load_serving``
(``mm3d_tpu_torch.training.inference``) and ``mm3d_tpu_torch.serving``
(``PredictionService``, ``make_server``) against ``mm3d_tpu``'s StableHLO
artifacts and daemon: the same weights (``load_jax_variables``), inputs
made with numpy from a seed, the same requests. The six ``mm3d::*``
kernel operators are checked with ``torch.library.opcheck``; on the kernel
path ``test_torch_fused_sa.fake_kernels`` runs each launch as its plain
twin, so an exported graph here holds the operator nodes the card serves.
The kernels themselves run only on the card (``chip_smoke.py`` phase 3g).
"""

import collections
import http.client
import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_sa import _inputs as _sa_operands
from test_torch_fused_sa import fake_kernels
from test_torch_fusion_semseg import _init, _np_tree
from test_torch_knn import _cloud_batch
from mm3d_tpu import serving as jax_serving
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.training import inference as jax_inference
from mm3d_tpu_torch import serving
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.models import get_model
from mm3d_tpu_torch.ops import _build, dispatch
from mm3d_tpu_torch.training import make_predictor
from mm3d_tpu_torch.training.inference import (export_serving, load_serving,
                                               save_serving)
from mm3d_tpu_torch.utils import load_jax_variables

TIMEOUT = 60  # seconds, each HTTP call


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads for each test, restored after (several test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mm3d_nodes(exported):
    """How many times the graph calls each mm3d operator, by name."""
    return dict(collections.Counter(
        str(n.target).split(".")[1] for n in exported.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("mm3d.")))


# ------------------------------------------------------ the operators


def _op_cases():
    """Each mm3d operator with small operands (B=2, 64 points, 16
    centroids, 8 neighbours)."""
    xyz, cents, pre, cbias, w1, b1, w2, b2 = _sa_operands(
        3, 2, 64, 16, 8, 16, 32)
    idx = torch.from_numpy(np.random.RandomState(4).randint(
        0, 64, (2, 16, 8)).astype(np.int32))
    r = np.random.RandomState(5)
    feat = torch.from_numpy(r.randn(2, 8, 8, 4).astype(np.float32))
    uv = torch.from_numpy((r.rand(2, 32, 2) * 9 - 0.5).astype(np.float32))
    skip = torch.from_numpy(r.randn(2, 64, 8).astype(np.float32))
    return {
        "farthest_point_sample": (xyz, 16, torch.zeros(2, dtype=torch.int32)),
        "query_ball_point": (0.4, 8, xyz, cents),
        "fused_sa": (0.4, 8, xyz, cents, pre, cbias, w1, b1, w2, b2),
        "fused_sa_idx": (8, idx, pre, cbias, w1, b1, w2, b2),
        "fused_fp": (xyz, cents, cbias.float(), skip),
        "bilinear_sample": (feat, uv),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_operator_opcheck(name, monkeypatch):
    """Schema, fake (shape) implementation, autograd registration and
    dispatch with dynamic shapes of each operator, its implementation on
    the kernel path (one launch a call), and its output against the plain
    path's."""
    ck = fake_kernels(monkeypatch)
    args = _op_cases()[name]
    op = getattr(torch.ops.mm3d, name)
    torch.library.opcheck(op, args)
    ck.reset_launches()
    got = op(*args)
    assert getattr(ck, name).launches == 1
    call = (ck._bilinear_forward if name == "bilinear_sample"
            else getattr(ck, name))
    with dispatch.use_impl("torch"):
        want = call(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


# ------------------------------------- kernel-path artifacts against JAX


def _fusion_cls_inputs():
    """B=2 clouds of 128 points with 32x32 images and cameras."""
    r = np.random.RandomState(5)
    return (r.randn(2, 128, 3).astype(np.float32),
            r.rand(2, 32, 32, 3).astype(np.float32),
            np.stack([np.eye(3, dtype=np.float32) * 16] * 2),
            np.stack([np.eye(3, dtype=np.float32)] * 2),
            np.array([[0, 0, 3.0]] * 2, np.float32))


# model, dtype -> (inputs, model kwargs, the graph's mm3d nodes, which are
# also the launches of one served forward)
KERNEL_CASES = {
    ("fusion_cls", "bfloat16"): (
        _fusion_cls_inputs, {"num_class": 6},
        {"farthest_point_sample": 2, "fused_sa": 2}),
    ("fusion_cls", "float32"): (
        _fusion_cls_inputs, {"num_class": 6},
        {"farthest_point_sample": 2, "query_ball_point": 2}),
    ("pointnet2_cls_knn", "bfloat16"): (
        lambda: (_cloud_batch(2, 256, 5),), {"num_class": 6},
        {"farthest_point_sample": 2, "fused_sa_idx": 2}),
    ("fusion_sem_seg", "bfloat16"): (
        lambda: tuple(syn.semseg_request(2, 256, (32, 32), seed=2)),
        {"num_class": 13},
        {"farthest_point_sample": 2, "fused_sa": 2, "fused_fp": 2,
         "bilinear_sample": 1}),
}


@pytest.mark.parametrize("name,dtname", sorted(KERNEL_CASES))
def test_kernel_path_artifact_matches_predictor_and_jax(
        name, dtname, tmp_path, monkeypatch):
    """An artifact exported on the kernel path holds one mm3d node a
    launch, serves make_predictor's log-probs bit for bit with those
    launches, and agrees with the JAX package's artifact of the same
    weights served by its daemon's service: fp32 within 1e-4, bf16 the
    same argmax (per point for segmentation, as
    tests/test_torch_fusion_semseg.py holds it: 95% of the points)."""
    make_inputs, kw, want_nodes = KERNEL_CASES[(name, dtname)]
    args = make_inputs()
    v = _init(jax_get_model(name).builder(**kw), args)
    state = load_jax_variables(get_model(name).builder(**kw),
                               _np_tree(v)).state_dict()
    bf16 = dtname == "bfloat16"
    ck = fake_kernels(monkeypatch)
    pred = make_predictor(name, state, dtype=torch.bfloat16 if bf16 else None,
                          device="cpu", **kw)
    ep = export_serving(pred, args)
    assert _mm3d_nodes(ep) == want_nodes
    path = str(tmp_path / f"{name}.pt2")
    save_serving(path, ep)
    service = serving.PredictionService(path, device="cpu")
    ck.reset_launches()
    got = service.predict(*args)
    assert {k.__name__: k.launches for k in ck.KERNELS
            if k.launches} == want_nodes
    want = pred(*map(torch.from_numpy, args)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)

    jpred = jax_inference.make_predictor(
        name, v, dtype=jnp.bfloat16 if bf16 else None, **kw)
    jpath = str(tmp_path / f"{name}.stablehlo")
    with jax.default_matmul_precision("float32"):
        jax_inference.save_serving(
            jpath, jax_inference.export_serving(jpred, args))
    jgot = jax_serving.PredictionService(jpath).predict(*args)
    assert jgot.shape == got.shape
    if not bf16:
        np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)
    else:
        agree = float(np.mean(got.argmax(-1) == jgot.argmax(-1)))
        print(f"{name} bf16 artifact vs JAX's: argmax agreement {agree}")
        assert agree == 1.0 if got.ndim == 2 else agree >= 0.95


# --------------------------------------- plain-path artifacts, the service


def _partseg_inputs(B, seed):
    """B unit-sphere clouds of 64 points and their categories one-hot."""
    cat = np.random.RandomState(seed).randint(0, 16, B)
    return (_cloud_batch(B, 64, seed), np.eye(16, dtype=np.float32)[cat])


@pytest.fixture(scope="module")
def partseg_pair(tmp_path_factory):
    """pointnet_part_seg (two inputs, per-point log-probs) with drawn BN
    statistics: the port's predictor and plain-path artifact at B=2, and
    the JAX package's artifact of the same weights."""
    d = tmp_path_factory.mktemp("partseg")
    name = "pointnet_part_seg"
    args = _partseg_inputs(2, 7)
    v = _init(jax_get_model(name).builder(), args)
    state = load_jax_variables(get_model(name).builder(),
                               _np_tree(v)).state_dict()
    pred = make_predictor(name, state, device="cpu")
    ep = export_serving(pred, args)
    port = str(d / "port.pt2")
    save_serving(port, ep)
    jax_path = str(d / "jax.stablehlo")
    with jax.default_matmul_precision("float32"):
        jax_inference.save_serving(jax_path, jax_inference.export_serving(
            jax_inference.make_predictor(name, v), args))
    return {"pred": pred, "exported": ep, "port": port, "jax": jax_path,
            "args": args}


def test_plain_path_artifact_matches_predictor(partseg_pair):
    """The plain path exports without mm3d nodes, serves make_predictor's
    log-probs bit for bit, and a fixed-shape artifact refuses other
    shapes, as JAX's does."""
    p = partseg_pair
    assert _mm3d_nodes(p["exported"]) == {}
    fn = load_serving(p["port"], device="cpu")
    targs = list(map(torch.from_numpy, p["args"]))
    with torch.no_grad():
        got = fn(*targs)
    assert torch.equal(got, p["pred"](*targs))
    with pytest.raises(Exception):
        fn(targs[0][:, :32], targs[1])
    with pytest.raises(Exception):
        fn(targs[0][:1], targs[1][:1])


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_poly_batch_artifact_serves_any_batch(path, tmp_path, monkeypatch):
    """poly_batch=True: one artifact serves batches of 1, 3 and 5, each
    equal to make_predictor at that batch; on the kernel path (bf16
    fusion_sem_seg) through its mm3d operators."""
    if path == "plain":
        name, kw, dt = "pointnet_part_seg", {}, None
        make = _partseg_inputs
    else:
        name, kw, dt = "fusion_sem_seg", {"num_class": 13}, torch.bfloat16
        ck = fake_kernels(monkeypatch)

        def make(B, seed):
            return tuple(syn.semseg_request(B, 128, (32, 32), seed=seed))
    model = get_model(name).builder(**kw)
    pred = make_predictor(name, model.state_dict(), dtype=dt, device="cpu",
                          **kw)
    ep = export_serving(pred, make(2, 1), poly_batch=True)
    assert bool(_mm3d_nodes(ep)) == (path == "kernel")
    save_serving(str(tmp_path / "poly.pt2"), ep)
    service = serving.PredictionService(str(tmp_path / "poly.pt2"), "cpu")
    spec = service.spec()
    assert service.batch is None and spec["batch"] == "poly"
    assert all(a["shape"][0] == "b" for a in spec["inputs"])
    for B in (1, 3, 5):
        args = make(B, 10 + B)
        if path == "kernel":
            ck.reset_launches()
        got = service.predict(*args)
        if path == "kernel":
            assert ck.fused_fp.launches == 2
        assert got.shape[0] == B
        assert np.array_equal(got, pred(*map(torch.from_numpy, args)).numpy())


def test_fixed_batch_service_chunks_like_jax(partseg_pair):
    """A B=2 artifact serves a batch of 5 by chunking and wrap-padding:
    each row is the row make_predictor gives in its chunk of 2 (the last
    padded with its first row), and within 1e-4 of JAX's service."""
    p = partseg_pair
    service = serving.PredictionService(p["port"], device="cpu")
    jservice = jax_serving.PredictionService(p["jax"])
    assert service.batch == jservice.batch == 2
    args = _partseg_inputs(5, 9)
    got = service.predict(*args)
    assert got.shape == (5, 64, 50)
    for lo in (0, 2, 4):
        chunk = [np.concatenate([a[lo:lo + 2], a[lo:lo + 1]])[:2]
                 for a in args]
        want = p["pred"](*map(torch.from_numpy, chunk)).numpy()
        n = min(2, 5 - lo)
        assert np.array_equal(got[lo:lo + n], want[:n])
    np.testing.assert_allclose(got, jservice.predict(*args), rtol=1e-4,
                               atol=1e-4)


CHECK_CASES = {
    "no inputs": lambda a: (),
    "three inputs": lambda a: (*a, a[1]),
    "shape": lambda a: (a[0][:, :32], a[1]),
    "rank": lambda a: (a[0][0], a[1]),
    "batch across inputs": lambda a: (a[0], a[1][:1]),
    "empty batch": lambda a: (a[0][:0], a[1][:0]),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_raises_like_jax(partseg_pair, case):
    """The service refuses each malformed request with JAX's ValueError
    and message: arity, shape, rank, batch across inputs, empty batch."""
    p = partseg_pair
    args = CHECK_CASES[case](_partseg_inputs(3, 8))
    msgs = []
    for service in (serving.PredictionService(p["port"], device="cpu"),
                    jax_serving.PredictionService(p["jax"])):
        with pytest.raises(ValueError) as e:
            service.predict(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------------- HTTP


def _serve(service, daemon=serving, **kw):
    """``daemon.make_server`` of the service, serving in a thread."""
    server = daemon.make_server(service, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.server_close()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _call(base, route, body=None):
    """(status, decoded body): JSON, or the npz's log_probs."""
    req = urllib.request.Request(f"{base}{route}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            code, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    if raw[:2] == b"PK":
        return code, np.load(io.BytesIO(raw))["log_probs"]
    return code, json.loads(raw)


def _bad_length(base):
    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "notanumber")
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_http_daemon_matches_jax(partseg_pair):
    """Both daemons, on loopback, answer one sequence of requests alike:
    /healthz, /spec (batch and inputs), a good /predict (log-probs within
    1e-4), wrong npz keys, a wrong shape, a bad Content-Length, an
    oversize body and unknown routes (400, 400, 400, 413, 404, 404), then
    /metrics with equal counters."""
    p = partseg_pair
    args = _partseg_inputs(3, 12)
    good = _npz(arg0=args[0], arg1=args[1])
    sequence = [
        ("/healthz", None), ("/spec", None), ("/predict", good),
        ("/predict", _npz(points=args[0], arg1=args[1])),
        ("/predict", _npz(arg0=args[0][:, :32], arg1=args[1])),
        "bad length",
        ("/predict", _npz(arg0=np.zeros((8, 256, 3), np.float32),
                          arg1=args[1])),
        ("/nowhere", None), ("/nowhere", good), ("/metrics", None)]
    answers = []
    for daemon, service in (
            (serving, serving.PredictionService(p["port"], device="cpu")),
            (jax_serving, jax_serving.PredictionService(p["jax"]))):
        server, base = _serve(service, daemon, max_body_mb=0.01)
        try:
            answers.append([_bad_length(base) if s == "bad length"
                            else _call(base, *s) for s in sequence])
        finally:
            _stop(server)
    port, jax_ = answers
    codes = [a[0] for a in port]
    assert codes == [a[0] for a in jax_] == [200, 200, 200, 400, 400, 400,
                                             413, 404, 404, 200]
    assert port[0][1] == jax_[0][1] == {"ok": True}
    spec, jspec = port[1][1], jax_[1][1]
    assert spec["batch"] == jspec["batch"] == 2
    assert spec["inputs"] == jspec["inputs"]
    assert spec["platforms"] == jspec["platforms"] == ["cpu"]
    np.testing.assert_allclose(port[2][1], jax_[2][1], rtol=1e-4, atol=1e-4)
    assert port[2][1].shape == (3, 64, 50)
    assert "limit" in port[6][1]["error"]
    m, jm = port[-1][1], jax_[-1][1]
    counters = ("requests_total", "errors_total", "clouds_total")
    assert [m[k] for k in counters] == [jm[k] for k in counters] == [5, 4, 3]
    assert m["latency_s"]["p50"] is not None


def test_concurrent_requests_match_serial(partseg_pair):
    """4 clients x 3 requests at once get the serial answers bit for bit,
    with a short thread switch interval; /metrics counts all 12."""
    service = serving.PredictionService(partseg_pair["port"], device="cpu")
    reqs = [_partseg_inputs(1 + i % 3, 20 + i) for i in range(12)]
    serial = [service.predict(*a) for a in reqs]
    server, base = _serve(service)
    got = [None] * 12

    def client(k):
        for i in range(k, 12, 4):
            got[i] = _call(base, "/predict",
                           _npz(arg0=reqs[i][0], arg1=reqs[i][1]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        metrics = _call(base, "/metrics")[1]
    finally:
        sys.setswitchinterval(interval)
        _stop(server)
    for (code, out), want in zip(got, serial):
        assert code == 200 and np.array_equal(out, want)
    assert metrics["requests_total"] == 12 and metrics["errors_total"] == 0
    assert metrics["clouds_total"] == sum(a[0].shape[0] for a in reqs)


# ---------------------------------------------------------- no fallback


def test_cuda_service_raises_without_a_card(partseg_pair, monkeypatch):
    """device='cuda' (the default) raises where CUDA is not available; a
    CPU artifact refuses a card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.PredictionService(partseg_pair["port"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        serving.PredictionService(partseg_pair["port"], device="cuda")
    with pytest.raises(ValueError, match="not a serving artifact"):
        serving.artifact_meta(partseg_pair["jax"])


def test_failed_kernel_fails_warmup_and_request(tmp_path, monkeypatch):
    """A kernel that does not build inside an operator fails the daemon's
    warmup and fails the request with 500: the served graph launches the
    kernels and has no plain path to fall back to."""
    name, kw = "pointnet2_cls_knn", {"num_class": 6}
    args = (_cloud_batch(2, 256, 5),)
    fake_kernels(monkeypatch)
    pred = make_predictor(name, get_model(name).builder(**kw).state_dict(),
                          dtype=torch.bfloat16, device="cpu", **kw)
    path = str(tmp_path / "knn.pt2")
    save_serving(path, export_serving(pred, args))
    monkeypatch.undo()

    def no_nvcc(lib):
        raise RuntimeError(f"nvcc failed for csrc/{lib}.cu")

    monkeypatch.setattr(_build, "load", no_nvcc)
    service = serving.PredictionService(path, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        service.warmup()
    server, base = _serve(service)
    try:
        code, body = _call(base, "/predict", _npz(arg0=args[0]))
        metrics = _call(base, "/metrics")[1]
    finally:
        _stop(server)
    assert code == 500 and "nvcc failed" in body["error"]
    assert metrics["errors_total"] == 1


def test_daemon_imports_no_model_code_or_jax():
    """Importing the daemon loads no model code, no JAX and nothing of the
    JAX package."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, mm3d_tpu_torch.serving\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'flax', 'mm3d_tpu') or "
         "m.startswith('mm3d_tpu_torch.models')]\n"
         "print(bad)"],
        capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
