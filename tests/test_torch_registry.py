"""The port's metrics registry (``fedml_tpu_torch/obs/registry.py``) against
the reference's (``fedml_tpu/obs/registry.py``): the same sequence of calls
on a fresh registry of each package renders byte for byte the same
Prometheus text and the same snapshot, label escaping, value formatting,
the default latency buckets and scoped registries included.  Host code on
both sides: equality is exact."""

import json
import math
import urllib.request

import numpy as np
import pytest


def _drive(reg_mod, seed: int):
    """One fixed sequence of registry calls, drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("fedml_requests_total", 'Requests "by" outcome\nsecond \\ line',
                    labels=("outcome", "tenant"))
    g = reg.gauge("fedml_depth", "Queue depth.")
    h = reg.histogram("fedml_latency_seconds", "Latency.", labels=("route",))
    hb = reg.histogram("fedml_fill", "Rows.", buckets=(1, 2, 4, 8, 16, 32))
    scoped = reg.scoped(job="job-a").counter("fedml_scoped_total", "Scoped.", labels=("k",))
    scoped_b = reg.scoped(job='job"b\n').counter("fedml_scoped_total", "Scoped.", labels=("k",))
    for _ in range(40):
        c.inc(float(rs.randint(1, 4)), outcome=rs.choice(["ok", "error", 'we"ird\\\n']),
              tenant=str(rs.randint(3)))
        g.set(float(rs.randn() * 10 ** rs.randint(-3, 17)))
        g.inc(0.25)
        h.observe(float(rs.exponential(0.01)), route=rs.choice(["/predict", "/ready"]))
        hb.observe(float(rs.randint(0, 40)))
        scoped.inc(k=str(rs.randint(2)))
        scoped_b.inc(2.5, k="x")
    g.set(float("inf"))
    reg.gauge("fedml_nan", "Not a number.").set(float("nan"))
    reg.gauge("fedml_big", "Large.").set(1e15 + 2)
    reg.gauge("fedml_neg", "Negative infinity.").set(-math.inf)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_and_snapshot_are_the_references(seed):
    from fedml_tpu.obs import registry as ref
    from fedml_tpu_torch.obs import registry as port

    want, got = _drive(ref, seed), _drive(port, seed)
    assert got.render() == want.render()
    assert json.dumps(got.snapshot(), sort_keys=True) == json.dumps(want.snapshot(),
                                                                    sort_keys=True)


def test_buckets_formatting_and_refusals_are_the_references():
    from fedml_tpu.obs import registry as ref
    from fedml_tpu_torch.obs import registry as port

    assert port.default_latency_buckets() == ref.default_latency_buckets()
    for v in (0.0, 1.0, -3.0, 1e15, 1e15 - 1, 0.1, 1 / 3, float("inf"), -float("inf"),
              float("nan"), 123456789.125):
        assert port._format_value(v) == ref._format_value(v)
    for mod in (ref, port):
        reg = mod.MetricsRegistry()
        reg.counter("fedml_x_total", labels=("a",))
        with pytest.raises(ValueError):
            reg.gauge("fedml_x_total", labels=("a",))
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("fedml_y", labels=("le",))
        with pytest.raises(ValueError):
            reg.counter("fedml_x_total", labels=("a",)).inc(-1, a="1")
        with pytest.raises(ValueError):
            reg.scoped(job="j").counter("fedml_z_total", labels=("job",))


def test_collect_hook_runs_before_render_and_snapshot():
    """The port's one addition: a hook that brings a family up to date
    before a scrape (the eager kernel timer's pending CUDA events)."""
    from fedml_tpu_torch.obs import registry as port

    reg = port.MetricsRegistry()
    g = reg.gauge("fedml_late", "Set by the hook.")
    calls = []

    def hook():
        calls.append(1)
        g.set(len(calls))

    reg.add_collect_hook(hook)
    assert "fedml_late 1" in reg.render()
    assert reg.snapshot()[0]["samples"][0]["value"] == 2.0


def test_metrics_http_server_serves_the_rendering():
    from fedml_tpu_torch.obs import registry as port

    reg = port.MetricsRegistry()
    reg.counter("fedml_hits_total", "Hits.").inc(3)
    server = port.MetricsHTTPServer(reg, port=0, host="127.0.0.1").start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            assert r.read().decode() == reg.render()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.close()
    assert port.maybe_start_metrics_server(None) is None
