"""Checks of the benchmark that need no run.

    python3 provbench/static_check.py

* no module of ``provbench/`` imports a module whose top-level name (the
  part before the first dot) is ``jax``, ``jaxlib``, ``flax`` or ``repro``
  (``repro_torch`` begins with ``repro`` and is allowed), and nothing
  under ``reference/`` imports the port or the harness's program side;
* every name, unit and key of ``BENCHMARK.json`` keeps to the allowed
  characters and lengths, and its shape is the contract's;
* every per-layer metric's cells report the end-to-end metric it moves;
* every file a cell needs exists: its configuration, its mix and loop,
  its tables' generators, each pipeline op's reference, each metric's
  reader.

Prints each fault and exits 1 if there is one.
"""
import ast
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_MAY_NOT = ("repro_torch", "torch", "provbench.program", "provbench.steps",
                     "provbench.loops", "provbench.harness")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def imported(path: Path):
    """Every module name ``path`` imports (absolute, as written)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def import_faults():
    for path in sorted(HERE.rglob("*.py")):
        rel = path.relative_to(ROOT)
        for mod in imported(path):
            if mod.split(".")[0] in FORBIDDEN:
                yield f"{rel} imports {mod}"
            if rel.parts[1] == "reference" and mod.startswith(REFERENCE_MAY_NOT):
                yield f"{rel} (the reference) imports {mod}"


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def bench_faults(b: dict):
    if set(b) != TOP_KEYS:
        yield f"BENCHMARK.json keys {sorted(b)}"
    if not (isinstance(b.get("run_seconds"), int) and 1 <= b["run_seconds"] <= 51):
        yield "run_seconds is not a whole number from 1 to 51"
    for p in b.get("paths", []):
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            yield f"path {p!r}"
    cmd = b.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        yield "command"
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in b.get(group, []):
            extra = set(e) - keys - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            if set(e) & keys != keys or extra:
                yield f"{group} entry {e.get('name')!r} keys {sorted(e)}"
            if not NAME.match(str(e.get("name", ""))):
                yield f"{group} name {e.get('name')!r}"
            if e.get("name") in names:
                yield f"name {e.get('name')!r} used twice"
            names.add(e.get("name"))
            if group in ("configs", "workloads") and not _line(e.get("why")):
                yield f"{group} {e.get('name')}: why"
            if group == "configs" and not _line(e.get("source")):
                yield f"config {e.get('name')}: source"
            if "unit" in e and not UNIT.match(e["unit"]):
                yield f"unit {e['unit']!r} of {e['name']}"
            if "better" in e and e["better"] not in ("lower", "higher"):
                yield f"better of {e['name']}"
            if group in ("end_to_end", "per_layer") and e.get("source") not in SOURCES:
                yield f"source of {e['name']}"
    configs = {c["name"]: c for c in b.get("configs", [])}
    cells = {w["name"]: w for w in b.get("workloads", [])}
    e2e = {m["name"]: m for m in b.get("end_to_end", [])}
    for c in configs.values():
        if not (ROOT / c["file"]).is_file() or not c["file"].startswith(tuple(b["paths"])):
            yield f"config file {c['file']}"
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            yield f"reduced of {c['name']}"
    if "setup_s" not in e2e:
        yield "no setup_s"
    for m in e2e.values():
        if m["source"] not in ("host_clock", "device_trace"):
            yield f"end-to-end {m['name']} from {m['source']}"
        if not (isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25):
            yield f"bound of {m['name']}"
    for m in b.get("per_layer", []):
        if not _line(m.get("layer")):
            yield f"layer of {m['name']}"
        moved = e2e.get(m["moves"])
        if moved is None:
            yield f"{m['name']} moves {m['moves']!r}, no end-to-end metric"
            continue
        for cell in m.get("workloads", list(cells)):
            if cell not in cells:
                yield f"{m['name']} names no cell {cell!r}"
            elif "workloads" in moved and cell not in moved["workloads"]:
                yield f"{m['name']} in {cell}, which does not report {m['moves']}"
    for m in list(e2e.values()) + b.get("per_layer", []):
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            yield f"no reader metrics/{m['name']}.py"
        for cell in m.get("workloads", []):
            if cell not in cells:
                yield f"{m['name']} names no cell {cell!r}"
    for w in cells.values():
        if w["chips"] not in (1, 4) or not _line(w["why"]):
            yield f"cell {w['name']}: chips or why"
        if w["config"] not in configs:
            yield f"cell {w['name']}: no config {w['config']!r}"
            continue
        reports = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        if len(reports) < 2:
            yield f"cell {w['name']} reports no end-to-end metric besides setup_s"
        if not any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"]):
            yield f"cell {w['name']} reports no per-layer metric"
        mix_file = HERE / "traffic" / f"{w['traffic']}.json"
        if not mix_file.is_file():
            yield f"cell {w['name']}: no traffic/{w['traffic']}.json"
            continue
        mix = json.loads(mix_file.read_text())
        if not (HERE / "loops" / f"{mix['loop']}.py").is_file():
            yield f"mix {w['traffic']}: no loops/{mix['loop']}.py"
        config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        for t in config["tables"]:
            if not (HERE / "tables" / f"{t['generator']}.py").is_file():
                yield f"config {w['config']}: no tables/{t['generator']}.py"
        for step in config["pipeline"]:
            if not (HERE / "reference" / "ops" / f"{step['op']}.py").is_file():
                yield f"config {w['config']}: no reference/ops/{step['op']}.py"
    four = sum(w["chips"] == 4 for w in cells.values())
    if four > max(1, len(cells) // 4):
        yield f"{four} cells on 4 chips"
    if len(json.dumps(b)) > 64 * 1024:
        yield "BENCHMARK.json over 64 KiB"


def faults():
    yield from import_faults()
    yield from bench_faults(json.loads((ROOT / "BENCHMARK.json").read_text()))


def main() -> int:
    found = list(faults())
    for f in found:
        print(f)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
