"""``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json`` (through the manifest's ``file``),
``mixes/<traffic>.json``, ``limits/<workload>.json``,
``metrics/<metric>.py`` and ``kinds/<kind>.py`` (a mix's ``kind``)."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def load(root: Path = ROOT) -> dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest['configs']:
        if c['name'] == name:
            return _json(root / c['file'])
    raise KeyError(f'no config {name!r} in BENCHMARK.json')


def mix(name: str) -> dict:
    return _json(BENCH / 'mixes' / f'{name}.json')


def limits(workload_name: str) -> dict:
    return _json(BENCH / 'limits' / f'{workload_name}.json')


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f'portbench_{tag}_' + re.sub(r'\W', '_', path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader of a metric: a module with ``read(ctx)`` that returns a
    number, or None where it finds nothing to read."""
    return _module(BENCH / 'metrics' / f'{name}.py', 'metric')


def kind(name: str):
    """The request kind a mix names: a module with a ``Kind`` class."""
    return _module(BENCH / 'kinds' / f'{name}.py', 'kind')


def metrics_of(manifest: dict, workload_name: str, traced: bool):
    """The metrics a run of the workload reports: its end-to-end metrics
    untraced, its per-layer ones traced (those without ``workloads``
    everywhere, the others where they list it)."""
    group = manifest['per_layer' if traced else 'end_to_end']
    return [m for m in group
            if workload_name in m.get('workloads', [workload_name])]


def problems(manifest: dict, root: Path = ROOT) -> list:
    """What in the manifest breaks the benchmark's rules of form: names,
    units, ``better``, ``moves``, and the files each name leads to."""
    out = []
    names = ([c['name'] for c in manifest['configs']]
             + [w['name'] for w in manifest['workloads']]
             + [m['name'] for m in manifest['end_to_end']
                + manifest['per_layer']])
    for n in names + [w['config'] for w in manifest['workloads']] + [
            w['traffic'] for w in manifest['workloads']] + [
            k for c in manifest['configs'] for k in c['reduced']]:
        if not NAME.match(n):
            out.append(f'bad name {n!r}')
    for group in ('configs', 'workloads'):
        seen = [e['name'] for e in manifest[group]]
        if len(set(seen)) != len(seen):
            out.append(f'repeated name in {group}')
    metric_names = [m['name'] for m in manifest['end_to_end']
                    + manifest['per_layer']]
    if len(set(metric_names)) != len(metric_names):
        out.append('repeated metric name')
    e2e = {m['name']: m for m in manifest['end_to_end']}
    if 'setup_s' not in e2e:
        out.append('no setup_s')
    cells = {w['name'] for w in manifest['workloads']}
    for m in manifest['end_to_end'] + manifest['per_layer']:
        if not UNIT.match(m['unit']):
            out.append(f'bad unit {m["unit"]!r} of {m["name"]}')
        if m['better'] not in ('lower', 'higher'):
            out.append(f'bad better of {m["name"]}')
        if not (BENCH / 'metrics' / f'{m["name"]}.py').is_file():
            out.append(f'no reader metrics/{m["name"]}.py')
        if not set(m.get('workloads', [])) <= cells:
            out.append(f'{m["name"]} lists an unknown workload')
    for m in manifest['per_layer']:
        if m['moves'] not in e2e:
            out.append(f'{m["name"]} moves no end-to-end metric')
            continue
        moved = e2e[m['moves']]
        for w in m.get('workloads', cells):
            if w not in moved.get('workloads', cells):
                out.append(f'{m["name"]} in {w}, which does not report '
                           f'{m["moves"]}')
    for w in manifest['workloads']:
        traffic = BENCH / 'mixes' / f'{w["traffic"]}.json'
        if not traffic.is_file():
            out.append(f'no mix {traffic.name}')
        elif not (BENCH / 'kinds' / f'{_json(traffic)["kind"]}.py') \
                .is_file():
            out.append(f'no kind for mix {w["traffic"]}')
        if not (BENCH / 'limits' / f'{w["name"]}.json').is_file():
            out.append(f'no limits for {w["name"]}')
        if w['config'] not in {c['name'] for c in manifest['configs']}:
            out.append(f'{w["name"]} names an unknown config')
        reported = [m for m in manifest['end_to_end']
                    if w['name'] in m.get('workloads', [w['name']])]
        if len(reported) < 2 or not metrics_of(manifest, w['name'], True):
            out.append(f'{w["name"]} reports too few metrics')
    for c in manifest['configs']:
        if not (root / c['file']).is_file():
            out.append(f'no file {c["file"]}')
    return out
