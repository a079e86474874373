"""Minimal XPlane (jax.profiler trace) reader — no tensorflow needed.

Parses the protobuf wire format directly with the XSpace/XPlane/XLine/
XEvent field numbers from tensorflow/core/profiler/protobuf/xplane.proto
and aggregates device-side event durations by op name over the GPU
device planes ("/device:GPU:<n>").

    python scripts/xplane.py TRACE_DIR [top_n]
"""

import glob
import gzip
import struct
import sys
from collections import defaultdict


def _varint(buf, i):
    x = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << s
        if not b & 0x80:
            return x, i
        s += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"wire type {wt}")
        yield fnum, wt, v


def parse_space(buf):
    """XSpace bytes -> [plane dict]."""
    planes = []
    for fnum, _, v in _fields(buf):
        if fnum == 1:
            planes.append(parse_plane(v))
    return planes


def parse_plane(buf):
    name = ""
    lines = []
    meta = {}
    for fnum, _, v in _fields(buf):
        if fnum == 2:
            name = v.decode("utf-8", "replace")
        elif fnum == 3:
            lines.append(parse_line(v))
        elif fnum == 4:  # map<int64, XEventMetadata>
            k = mname = None
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    k = v2
                elif f2 == 2:
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            k = v3 if k is None else k
                        elif f3 == 2:
                            mname = v3.decode("utf-8", "replace")
            if k is not None:
                meta[k] = mname or f"meta:{k}"
    return dict(name=name, lines=lines, meta=meta)


def parse_line(buf):
    name = ""
    events = []
    for fnum, _, v in _fields(buf):
        if fnum == 2:
            name = v.decode("utf-8", "replace")
        elif fnum == 11:
            name = v.decode("utf-8", "replace") or name
        elif fnum == 4:
            mid = dur = 0
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    mid = v2
                elif f2 == 3:
                    dur = v2
            events.append((mid, dur))
    return dict(name=name, events=events)


def load_dir(path):
    files = glob.glob(f"{path}/**/*.xplane.pb", recursive=True)
    spaces = []
    for f in files:
        raw = open(f, "rb").read()
        if f.endswith(".gz"):
            raw = gzip.decompress(raw)
        spaces.append(parse_space(raw))
    return spaces


def device_op_totals(path, plane_filter=("/device:GPU",)):
    """Aggregate event durations (ms) by op name over device planes.
    Returns (totals dict, plane names seen)."""
    totals = defaultdict(float)
    counts = defaultdict(int)
    seen = []
    for space in load_dir(path):
        for plane in space:
            seen.append(plane["name"])
            if not any(s.lower() in plane["name"].lower() for s in plane_filter):
                continue
            for line in plane["lines"]:
                for mid, dur in line["events"]:
                    nm = plane["meta"].get(mid, f"meta:{mid}")
                    totals[nm] += dur / 1e9  # ps -> ms
                    counts[nm] += 1
    return totals, counts, seen


def main():
    path = sys.argv[1]
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    totals, counts, seen = device_op_totals(path)
    if not totals:
        print("no device events; planes seen:", sorted(set(seen)))
        return
    print(f"{'total ms':>10} {'n':>6}  op")
    gross = sum(totals.values())
    for nm, ms in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:10.3f} {counts[nm]:6d}  {nm[:110]}")
    print(f"{gross:10.3f}        TOTAL (all device events)")


if __name__ == "__main__":
    main()
