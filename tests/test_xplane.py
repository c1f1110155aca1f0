"""The xplane trace parser and the 3-tier kernel-duration chain.

The reference's primary profiling tier parses ncu CSV into per-kernel
durations (backend/profiling/ncu_profiler.py:406-723); ours parses the
XSpace protobuf jax.profiler writes.  These tests cover (a) the wire-format
parser against a hand-serialized XSpace, (b) a live capture round-trip,
(c) the tier selection + source tagging in profile_filter.
"""

import numpy as np
import pytest

from gpu_image_processing.profiling import xplane
from gpu_image_processing.profiling.profiler import (
    get_common_metrics,
    profile_filter,
)

from .conftest import make_image


# ---------------------------------------------------------------------------
# Minimal protobuf wire ENCODER (test-side mirror of the parser)
# ---------------------------------------------------------------------------


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    tag = _varint((fnum << 3) | wtype)
    if wtype == 0:
        return tag + payload  # payload already varint-encoded
    if wtype in (1, 5):
        return tag + payload  # fixed64/fixed32: raw bytes, no length
    return tag + _varint(len(payload)) + payload


def _stat(metadata_id: int, *, double=None, u64=None, i64=None, s=None,
          ref=None) -> bytes:
    import struct

    buf = _field(1, 0, _varint(metadata_id))
    if double is not None:
        buf += _field(2, 1, struct.pack("<d", double))
    if u64 is not None:
        buf += _field(3, 0, _varint(u64))
    if i64 is not None:
        buf += _field(4, 0, _varint(i64 & ((1 << 64) - 1)))
    if s is not None:
        buf += _field(5, 2, s.encode())
    if ref is not None:
        buf += _field(7, 0, _varint(ref))
    return buf


def _event(metadata_id: int, offset_ps: int, duration_ps: int,
           stats: list[bytes] = ()) -> bytes:
    buf = (
        _field(1, 0, _varint(metadata_id))
        + _field(2, 0, _varint(offset_ps))
        + _field(3, 0, _varint(duration_ps))
    )
    for st in stats:
        buf += _field(4, 2, st)
    return buf


def _line(name: str, events: list[bytes]) -> bytes:
    buf = _field(2, 2, name.encode())
    for ev in events:
        buf += _field(4, 2, ev)
    return buf


def _event_metadata_entry(mid: int, name: str, display: str = "",
                          stats: list[bytes] = ()) -> bytes:
    meta = _field(1, 0, _varint(mid)) + _field(2, 2, name.encode())
    if display:
        meta += _field(3, 2, display.encode())
    for st in stats:  # XEventMetadata.stats (field 5): invariant stats
        meta += _field(5, 2, st)
    return _field(1, 0, _varint(mid)) + _field(2, 2, meta)


def _stat_metadata_entry(sid: int, name: str) -> bytes:
    meta = _field(1, 0, _varint(sid)) + _field(2, 2, name.encode())
    return _field(1, 0, _varint(sid)) + _field(2, 2, meta)


def _plane(name: str, lines: list[bytes], metadata: list[bytes],
           stat_metadata: list[bytes] = ()) -> bytes:
    buf = _field(2, 2, name.encode())
    for ln in lines:
        buf += _field(3, 2, ln)
    for m in metadata:
        buf += _field(4, 2, m)
    for m in stat_metadata:
        buf += _field(5, 2, m)
    return buf


def _xspace(planes: list[bytes]) -> bytes:
    return b"".join(_field(1, 2, p) for p in planes)


def _synthetic_device_space() -> bytes:
    """A /device:GPU:0 plane with an 'XLA Ops' line: the fused pallas
    kernel twice (0.5 ms + 0.7 ms) and a pad fusion once (0.1 ms); plus a
    host plane that must be ignored."""
    dev = _plane(
        "/device:GPU:0",
        [
            _line(
                "XLA Ops",
                [
                    _event(7, 0, 500_000_000),       # 0.5 ms
                    _event(7, 600_000_000, 700_000_000),  # 0.7 ms
                    _event(9, 0, 100_000_000),       # 0.1 ms
                ],
            ),
            _line("Steps", [_event(3, 0, 999)]),
        ],
        [
            _event_metadata_entry(7, "fusion.1", "gaussian_rows_kernel"),
            _event_metadata_entry(9, "fusion.2", "pad_fusion"),
            _event_metadata_entry(3, "step"),
        ],
    )
    host = _plane(
        "/host:CPU",
        [_line("python", [_event(1, 0, 12345)])],
        [_event_metadata_entry(1, "PjitFunction")],
    )
    return _xspace([dev, host])


def test_parse_synthetic_xspace():
    planes = xplane.parse_xspace_bytes(_synthetic_device_space())
    assert [p.name for p in planes] == ["/device:GPU:0", "/host:CPU"]
    dev = planes[0]
    assert xplane.is_device_plane(dev)
    assert not xplane.is_device_plane(planes[1])
    assert [l.name for l in dev.lines] == ["XLA Ops", "Steps"]
    assert dev.event_name(7) == "gaussian_rows_kernel"  # display_name wins
    assert dev.event_name(9) == "pad_fusion"

    agg = xplane.kernel_durations_from_planes(planes)
    # Only the XLA Ops line of the device plane is aggregated: the host
    # plane's python events and the Steps line must not leak in.
    assert set(agg) == {"gaussian_rows_kernel", "pad_fusion"}
    assert agg["gaussian_rows_kernel"]["count"] == 2
    assert agg["gaussian_rows_kernel"]["total_ms"] == pytest.approx(1.2)
    assert agg["gaussian_rows_kernel"]["avg_ms"] == pytest.approx(0.6)
    assert agg["pad_fusion"]["total_ms"] == pytest.approx(0.1)


def test_xstat_payloads_harvested():
    """XEvent field-4 XStat payloads reach the aggregate: numeric stats
    sum across executions (divide by count for per-exec), string and
    ref-interned stats land in attrs (VERDICT r2 item 3; ncu's per-kernel
    counter table, ncu_profiler.py:406-723)."""
    dev = _plane(
        "/device:GPU:0",
        [
            _line(
                "XLA Ops",
                [
                    _event(7, 0, 500_000_000, stats=[
                        _stat(20, u64=1000),          # flops
                        _stat(21, double=2048.5),     # bytes accessed
                        _stat(22, s="fusion"),        # hlo_category (str)
                        _stat(24, i64=-3),            # negative int64
                    ]),
                    _event(7, 600_000_000, 700_000_000, stats=[
                        _stat(20, u64=1000),
                        _stat(21, double=2048.5),
                        _stat(23, ref=25),            # ref-interned string
                    ]),
                ],
            ),
        ],
        [_event_metadata_entry(7, "fusion.1", "gaussian_rows_kernel")],
        [
            _stat_metadata_entry(20, "flops"),
            _stat_metadata_entry(21, "bytes accessed"),
            _stat_metadata_entry(22, "hlo_category"),
            _stat_metadata_entry(23, "equation"),
            _stat_metadata_entry(24, "delta"),
            _stat_metadata_entry(25, "interned value"),
        ],
    )
    planes = xplane.parse_xspace_bytes(_xspace([dev]))
    agg = xplane.kernel_durations_from_planes(planes)
    k = agg["gaussian_rows_kernel"]
    assert k["count"] == 2
    assert k["stats"]["flops"] == 2000                  # summed
    assert k["stats"]["bytes accessed"] == pytest.approx(4097.0)
    assert k["stats"]["delta"] == -3                    # two's complement
    assert k["attrs"]["hlo_category"] == "fusion"
    assert k["attrs"]["equation"] == "interned value"   # ref resolved


def test_metadata_level_stats_harvested():
    """XEventMetadata.stats (field 5) is where XLA attaches the per-op
    INVARIANT cost counters (flops, bytes_accessed -- on such planes the
    events themselves carry only timing stats, so a decoder reading only
    XEvent.stats harvests no cost data at all).
    Metadata stats accumulate once per occurrence, exactly like event
    stats, and combine with them."""
    dev = _plane(
        "/device:GPU:0",
        [
            _line(
                "XLA Ops",
                [
                    _event(7, 0, 500_000_000, stats=[
                        _stat(26, u64=77),            # per-occurrence stat
                    ]),
                    _event(7, 600_000_000, 700_000_000),
                ],
            ),
        ],
        [
            _event_metadata_entry(7, "fusion.1", "gaussian_rows_kernel",
                                  stats=[
                                      _stat(20, u64=1000),   # flops
                                      _stat(21, double=2048.5),
                                      _stat(22, s="fusion"),
                                  ]),
        ],
        [
            _stat_metadata_entry(20, "flops"),
            _stat_metadata_entry(21, "bytes accessed"),
            _stat_metadata_entry(22, "hlo_category"),
            _stat_metadata_entry(26, "occ_bytes"),
        ],
    )
    planes = xplane.parse_xspace_bytes(_xspace([dev]))
    assert planes[0].event_stats[7]  # parsed onto the plane
    agg = xplane.kernel_durations_from_planes(planes)
    k = agg["gaussian_rows_kernel"]
    assert k["count"] == 2
    assert k["stats"]["flops"] == 2000          # invariant stat x 2 occurrences
    assert k["stats"]["bytes accessed"] == pytest.approx(4097.0)
    assert k["stats"]["occ_bytes"] == 77        # event-level still harvested
    assert k["attrs"]["hlo_category"] == "fusion"


def test_events_without_stats_unchanged():
    """Events carrying no stats aggregate exactly as before (no 'stats'
    key invented)."""
    planes = xplane.parse_xspace_bytes(_synthetic_device_space())
    agg = xplane.kernel_durations_from_planes(planes)
    assert "stats" not in agg["gaussian_rows_kernel"]
    assert "attrs" not in agg["gaussian_rows_kernel"]


def test_noise_ops_filtered(tmp_path):
    space = _xspace(
        [
            _plane(
                "/device:GPU:0",
                [
                    _line(
                        "XLA Ops",
                        [_event(1, 0, 10_000_000), _event(2, 0, 20_000_000)],
                    )
                ],
                [
                    _event_metadata_entry(1, "copy-start.1"),
                    _event_metadata_entry(2, "real_kernel"),
                ],
            )
        ]
    )
    d = tmp_path / "plugins" / "profile" / "2026_01_01"
    d.mkdir(parents=True)
    (d / "host.xplane.pb").write_bytes(space)
    agg = xplane.serving_kernel_durations(str(tmp_path))
    assert set(agg) == {"real_kernel"}


def test_live_capture_roundtrip(tmp_path, rng):
    """A real jax.profiler capture parses cleanly; the CPU backend has no
    device plane, so the kernel-duration table is empty (-> tier falls)."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sum(x.astype(jnp.float32)) * 2)
    x = np.ones((64, 64), np.uint8)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()

    files = xplane.find_xplane_files(str(tmp_path))
    assert files, "jax.profiler must write an .xplane.pb"
    planes = xplane.parse_xspace_file(files[0])
    assert planes
    host = [p for p in planes if p.name == "/host:CPU"]
    assert host and any(l.events for l in host[0].lines)
    assert xplane.device_kernel_durations(str(tmp_path)) == {}


def test_trace_tier_tags_and_rows(rng, monkeypatch):
    """When the trace tier yields device kernels, profile_filter reports
    THOSE as kernel rows, tagged source=xplane_trace (VERDICT r2 item 2)."""
    from gpu_image_processing.profiling import profiler as prof

    fake = {
        "gaussian_rows_kernel": {"count": 4, "total_ms": 2.0, "avg_ms": 0.5},
        "pad_fusion": {"count": 4, "total_ms": 0.4, "avg_ms": 0.1},
    }
    monkeypatch.setattr(prof, "_trace_kernel_breakdown", lambda key, fn: fake)
    img = make_image(rng, 16, 20, 3)
    deep = prof.profile_filter(img, "gaussian", 2, sigma=2.0, radius=3)
    assert deep["duration_source"] == "xplane_trace"
    assert deep["kernels_profiled"] == ["gaussian_rows_kernel", "pad_fusion"]
    assert deep["kernel_durations_ms"]["gaussian_rows_kernel"] == 0.5
    assert "per_pass_durations_ms" not in deep
    assert "Duration gaussian_rows_kernel (ms)" in deep["execution"]

    common = get_common_metrics(deep, ncu_data=deep)
    assert common["kernel_duration_source"] == "xplane_trace"
    assert common["kernel_durations"] == [0.5, 0.1]
    assert common["kernels_profiled"] == ["gaussian_rows_kernel", "pad_fusion"]
    # The trace must never displace the primary device-timed total.
    assert common["time_ms"] == deep["total_kernel_duration_ms"]


def test_trace_op_stats_surface_in_categorized_dict(rng, monkeypatch):
    """Harvested per-op stats reach the categorized dict: per-exec flops
    and bytes totals plus per-op measured bandwidth rows (VERDICT r2 #3)."""
    from gpu_image_processing.profiling import profiler as prof

    fake = {
        "gaussian_rows_kernel": {
            "count": 4, "total_ms": 2.0, "avg_ms": 0.5,
            "stats": {"flops": 4000, "bytes accessed": 4.0e6,
                      "program_id": 4 * 7},
            "attrs": {"hlo_category": "fusion"},
        },
        "pad_fusion": {"count": 4, "total_ms": 0.4, "avg_ms": 0.1},
    }
    monkeypatch.setattr(prof, "_trace_kernel_breakdown", lambda key, fn: fake)
    img = make_image(rng, 16, 20, 3)
    deep = prof.profile_filter(img, "gaussian", 2, sigma=2.0, radius=3)
    assert deep["duration_source"] == "xplane_trace"
    # Summed-over-window stats divided back to per-execution values.
    ops = deep["trace_op_stats"]
    assert ops["gaussian_rows_kernel"]["flops"] == 1000
    assert ops["gaussian_rows_kernel"]["bytes accessed"] == 1.0e6
    assert "pad_fusion" not in ops  # no stats -> no row invented
    assert deep["execution"]["Trace FLOPs (per exec)"] == 1000
    assert deep["memory"]["Trace Bytes Accessed (per exec)"] == 1.0e6
    # Measured per-op bandwidth: 1e6 bytes / 0.5 ms = 2 GB/s.
    bw = deep["occupancy"]["Bandwidth gaussian_rows_kernel (Gbyte/s, trace)"]
    assert bw == pytest.approx(2.0)
    # No new flat common keys invented (the UI renders these section rows
    # through the deep-dict Other sweep).
    common = get_common_metrics(deep, ncu_data=deep)
    assert common["kernel_duration_source"] == "xplane_trace"


def test_estimate_tier_tagged_on_cpu(rng):
    """On the CPU backend the capture has no device plane, so the chain
    falls to the isolated-pass estimate -- and SAYS so (the round-1 UI
    presented estimates as measurements; the tag fixes that)."""
    img = make_image(rng, 16, 22, 3)
    deep = profile_filter(img, "box", 2, radius=4)
    assert deep["duration_source"] in (
        "isolated_pass_estimate",
        "device_timing",
    )
    common = get_common_metrics(deep, ncu_data=deep)
    assert common["kernel_duration_source"] == deep["duration_source"]


def test_hlo_instruction_names_shorten_in_ui_keys(rng, monkeypatch):
    """Some device planes name events with the FULL HLO instruction text;
    UI-facing keys (Duration/Bandwidth rows) use the short op name, while
    programmatic dicts (kernel_durations_ms, trace_kernel_stats) keep the
    full text.  Display-style names and short-name collisions fall back
    to the full name."""
    from gpu_image_processing.profiling import profiler as prof

    long1 = "%_lambda_.1 = u8[1,64,640] custom-call(u8[1,66,768] %pad.0)"
    long2 = "%pad.0 = u8[1,66,768] pad(u8[1,64,640] %bitcast.1)"
    fake = {
        long1: {"count": 2, "total_ms": 1.0, "avg_ms": 0.5,
                "stats": {"bytes_accessed": 2_000_000.0}},
        long2: {"count": 2, "total_ms": 0.2, "avg_ms": 0.1},
        "display_named_kernel": {"count": 2, "total_ms": 0.1, "avg_ms": 0.05},
    }
    monkeypatch.setattr(prof, "_trace_kernel_breakdown", lambda key, fn: fake)
    img = make_image(rng, 16, 20, 3)
    deep = prof.profile_filter(img, "gaussian", 2, sigma=2.0, radius=3)
    assert "Duration %_lambda_.1 (ms)" in deep["execution"]
    assert "Duration %pad.0 (ms)" in deep["execution"]
    assert "Duration display_named_kernel (ms)" in deep["execution"]
    assert f"Duration {long1} (ms)" not in deep["execution"]
    assert any(k.startswith("Bandwidth %_lambda_.1 ")
               for k in deep["occupancy"])
    # programmatic keys keep the full HLO text
    assert long1 in deep["kernel_durations_ms"]
    assert long1 in deep["trace_kernel_stats"]


def test_overlap_annotated_from_intervals():
    """Synthetic plane: pad_fusion [0, 0.1 ms] runs inside the kernel's
    first occurrence [0, 0.5 ms]; the kernel's second occurrence
    [0.6, 1.3 ms] is alone.  Both ops get 0.1 ms of cross-op overlap."""
    planes = xplane.parse_xspace_bytes(_synthetic_device_space())
    agg = xplane.kernel_durations_from_planes(planes)
    kern = agg["gaussian_rows_kernel"]
    pad = agg["pad_fusion"]
    assert abs(kern["overlap_ms"] - 0.1) < 1e-9
    assert abs(pad["overlap_ms"] - 0.1) < 1e-9
    # Durations unchanged by the annotation.
    assert abs(kern["total_ms"] - 1.2) < 1e-9


def test_self_overlap_not_counted_as_cross_op():
    """Two occurrences of the SAME op overlapping each other are not
    cross-op concurrency (grid re-execution inside one window)."""
    agg = {"a": {"count": 2, "total_ms": 2.0, "avg_ms": 1.0}}
    xplane._annotate_overlap(
        agg, {"a": [(0, 1_000_000_000), (500_000_000, 1_500_000_000)]})
    assert agg["a"]["overlap_ms"] == 0.0
