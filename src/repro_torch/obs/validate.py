"""Validate observability files against the documented schema, the
counterpart of ``repro/obs/validate.py`` (the port's own copy, so a machine
without JAX can check them):

    PYTHONPATH=src python -m repro_torch.obs.validate trace.jsonl metrics.txt

Checks, per artifact:

* **JSONL trace** — every line parses; every record has ``event`` (str),
  monotone ``seq`` (int), ``ts`` (number); the stream opens with a
  ``session`` record (matching
  :data:`repro_torch.obs.trace.SCHEMA_VERSION`) and ends with
  ``session_end``; ``round`` records carry the full telemetry schema
  (:data:`repro_torch.obs.telemetry.FIELDS`); every ``select`` record's
  ``pulls`` equals the summed ``pulls`` of the ``round`` records since the
  previous ``select`` — the pull-reconciliation acceptance check;
* **metrics exposition** — non-empty; every line is a ``# HELP`` / ``# TYPE``
  comment or a ``name{labels} value`` sample; every sample's family has a
  preceding TYPE line; histogram ``_count`` equals its ``+Inf`` bucket.

Both validators raise ``ValueError`` with a line-numbered message on the
first violation and return a summary dict on success.
"""
from __future__ import annotations

import json
import re
import sys

from repro_torch.obs.telemetry import FIELDS as ROUND_FIELDS
from repro_torch.obs.trace import SCHEMA_VERSION

_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?P<labels>\{[^{}]*\})?\s+(?P<value>[^\s]+)$')
_COMMENT = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$")


def validate_trace(path: str) -> dict:
    """Validate one JSONL trace file; returns ``{"events": N, "rounds": R,
    "selects": S}``."""
    events = by_type = None
    with open(path) as fh:
        lines = fh.read().splitlines()
    if not lines:
        raise ValueError(f"{path}: empty trace")
    events, by_type = [], {}
    for i, line in enumerate(lines, 1):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i}: not JSON ({e})") from None
        if not isinstance(rec, dict):
            raise ValueError(f"{path}:{i}: record is not an object")
        for field, types in (("event", str), ("seq", int),
                             ("ts", (int, float))):
            if not isinstance(rec.get(field), types):
                raise ValueError(f"{path}:{i}: missing/invalid {field!r}")
        if rec["seq"] != len(events):
            raise ValueError(f"{path}:{i}: seq {rec['seq']} != {len(events)}")
        events.append(rec)
        by_type[rec["event"]] = by_type.get(rec["event"], 0) + 1
    if events[0]["event"] != "session":
        raise ValueError(f"{path}: first record must be 'session'")
    if events[0].get("version") != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema version {events[0].get('version')} "
                         f"!= {SCHEMA_VERSION}")
    if events[-1]["event"] != "session_end":
        raise ValueError(f"{path}: last record must be 'session_end'")

    pulls_since_select = 0
    rounds_since_select = 0
    for i, rec in enumerate(events, 1):
        if rec["event"] == "round":
            missing = [k for k in ROUND_FIELDS if k not in rec]
            if missing or not isinstance(rec.get("r"), int):
                raise ValueError(f"{path}:{i}: round record missing "
                                 f"{missing or ['r']}")
            pulls_since_select += int(rec["pulls"])
            rounds_since_select += 1
        elif rec["event"] == "select":
            if not isinstance(rec.get("pulls"), int):
                raise ValueError(f"{path}:{i}: select without int 'pulls'")
            if rounds_since_select and pulls_since_select != rec["pulls"]:
                raise ValueError(
                    f"{path}:{i}: select pulls={rec['pulls']} but the "
                    f"{rounds_since_select} preceding round records sum to "
                    f"{pulls_since_select}")
            pulls_since_select = rounds_since_select = 0
        elif rec["event"] == "span":
            if not isinstance(rec.get("name"), str) \
                    or not isinstance(rec.get("dur_s"), (int, float)):
                raise ValueError(f"{path}:{i}: span without name/dur_s")
    return {"events": len(events), "rounds": by_type.get("round", 0),
            "selects": by_type.get("select", 0)}


def validate_exposition(path: str) -> dict:
    """Validate one Prometheus text-exposition file; returns
    ``{"families": F, "samples": S}``."""
    with open(path) as fh:
        text = fh.read()
    if not text.strip():
        raise ValueError(f"{path}: empty exposition")
    typed: dict[str, str] = {}
    inf_bucket: dict[str, int] = {}
    counts: dict[str, int] = {}
    samples = 0
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _COMMENT.match(line):
                raise ValueError(f"{path}:{i}: malformed comment {line!r}")
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split(None, 3)
                typed[name] = kind
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"{path}:{i}: malformed sample {line!r}")
        try:
            float(m.group("value"))
        except ValueError:
            raise ValueError(f"{path}:{i}: non-numeric value "
                             f"{m.group('value')!r}") from None
        name = m.group("name")
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and family not in typed:
            raise ValueError(f"{path}:{i}: sample {name!r} has no TYPE line")
        if name.endswith("_bucket") and 'le="+Inf"' in (m.group("labels")
                                                        or ""):
            key = family + (m.group("labels") or "").replace(',le="+Inf"', "") \
                                                   .replace('le="+Inf"', "")
            if key.endswith("{}"):
                key = key[:-2]
            inf_bucket[key] = int(float(m.group("value")))
        if name.endswith("_count"):
            key = family + (m.group("labels") or "")
            counts[key] = int(float(m.group("value")))
        samples += 1
    for key, c in counts.items():
        if key in inf_bucket and inf_bucket[key] != c:
            raise ValueError(f"{path}: histogram {key}: +Inf bucket "
                             f"{inf_bucket[key]} != _count {c}")
    return {"families": len(typed), "samples": samples}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate "
              "[trace.jsonl ...] [metrics.txt ...]", file=sys.stderr)
        return 2
    for path in argv:
        if path.endswith(".jsonl"):
            summary = validate_trace(path)
        else:
            summary = validate_exposition(path)
        print(f"{path}: OK {json.dumps(summary)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
