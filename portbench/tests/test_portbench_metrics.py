"""The span arithmetic, the trace reduction and each per-layer reader on
small synthetic inputs."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans, trace


def test_span_totals_and_self_time():
    ev = [("seed_wait", 0.0, 1.0), ("io", 0.2, 0.5), ("compute", 1.0, 3.0), ("io", 3.0, 3.5)]
    t = spans.totals(ev, 0.0, 4.0)
    assert t["total"] == pytest.approx({"seed_wait": 1.0, "io": 0.8, "compute": 2.0})
    assert t["self"]["seed_wait"] == pytest.approx(0.7)
    clipped = spans.totals(ev, 0.5, 4.0)
    assert clipped["total"]["seed_wait"] == pytest.approx(0.5)


def test_wrappers_time_calls_and_steps_and_restore():
    class Tool:
        def step(self, x):
            return x + 1

        def batches(self):
            yield from range(3)

    tool, s = Tool(), spans.Spans()
    s.wrap_method(tool, "step", "compute")
    s.wrap_iterator_method(tool, "batches", "io")
    assert tool.step(1) == 2 and list(tool.batches()) == [0, 1, 2]
    names = [e[0] for e in s.events]
    assert names.count("compute") == 1 and names.count("io") == 4
    s.restore()
    assert "step" not in vars(tool)


def _events():
    us = 1000
    return [
        ("kernel", "overlap_bits_kernel(unsigned char const*)", 300 * us, 100 * us),
        ("kernel", "void at::native::elementwise_kernel<4>(int)", 350 * us, 150 * us),
        ("gpu_memcpy", "Memcpy DtoH", 800 * us, 50 * us),
        ("cuda_runtime", "cudaLaunchKernel", 10 * us, 5 * us),
    ]


def test_trace_reduction():
    r = trace.reduce(_events(), 0, 1000 * 1000, [("io", 0, 300 * 1000)])
    assert r["wall_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(250e-6)
    assert len(r["kernels"]) == 2
    assert sorted(r["idle_gaps"]) == [("io", pytest.approx(300e-6)), ("loop", pytest.approx(150e-6)),
                                      ("loop", pytest.approx(300e-6))]


def test_a_trace_on_another_clock_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(_events(), 10**12, 10**12 + 10**6, [])


def _ctx(tr=None, **kw):
    names = {"overlap_bits_kernel", "overlap_byte_kernel"}
    base = dict(spans={"total": {"compute": 6.0, "io": 2.0, "seed_wait": 1.5},
                       "self": {"compute": 6.0, "io": 2.0, "seed_wait": 1.0}},
                span_wall=10.0, span_cpu=4.0, mbp_measured=2.0, trace=tr, mbp_traced=0.5,
                job_wall=0.5e-3, peak_bytes=3 * 2**30, work={},
                peaks=harness.read_json(harness.HERE, "peaks.json"),
                counts=lambda n: harness.load("counts", n), kernels_of=lambda src: names,
                is_port_kernel=lambda n, s=None: trace.is_port_kernel(n, names if s is None else s))
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    tr = trace.reduce(_events(), 0, 1000 * 1000, [])
    read = {m: harness.load("metrics", m).read for m in
            ("compute_pct", "io_pct", "seed_wait_pct", "launches_per_mbp", "kernel_ms_per_mbp",
             "device_idle_pct", "device_peak_gib", "overlap_scan_roofline",
             "host_cpu_s_per_mbp")}
    ctx = _ctx(tr, work={"overlap_scan": [{"pairs": 100, "width": 151, "inserts": 290}]})
    assert read["compute_pct"](ctx) == pytest.approx(60.0)
    assert read["io_pct"](ctx) == pytest.approx(20.0)
    assert read["seed_wait_pct"](ctx) == pytest.approx(10.0)
    assert read["launches_per_mbp"](ctx) == pytest.approx(4.0)
    assert read["kernel_ms_per_mbp"](ctx) == pytest.approx(0.1 / 0.5)
    # busy 250 us of an untraced job's 500 us (the profiled job took 1 ms)
    assert read["device_idle_pct"](ctx) == pytest.approx(50.0)
    assert read["device_peak_gib"](ctx) == pytest.approx(3.0)
    assert read["host_cpu_s_per_mbp"](ctx) == pytest.approx(2.0)
    nbytes = 2 * 100 * 151 + 8 * 100 + 12 * 100 * 290
    assert read["overlap_scan_roofline"](ctx) == pytest.approx(100 * nbytes / 3.35e12 / 100e-6)


def test_readers_with_nothing_to_read_return_nothing():
    ctx = _ctx(None, spans={"total": {}, "self": {}}, peak_bytes=0, mbp_measured=0.0)
    for m in ("compute_pct", "seed_wait_pct", "launches_per_mbp", "kernel_ms_per_mbp",
              "device_idle_pct", "device_peak_gib", "overlap_scan_roofline", "host_cpu_s_per_mbp"):
        assert harness.load("metrics", m).read(ctx) is None


def test_jobs_time_each_job():
    jobs = harness.Jobs()
    for _ in range(3):
        with jobs.timed():
            sum(range(10000))
    assert jobs.n == 3 and all(r[0] > 0 for r in jobs.rows)
    assert jobs.median_wall() == sorted(r[0] for r in jobs.rows)[1]
    assert jobs.cpu >= 0
