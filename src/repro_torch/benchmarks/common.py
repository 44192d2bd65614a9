"""Shared benchmark helpers: the CSV rows and the guards of the
machine-readable records.

A copy of the pure-Python parts of the reference's ``benchmarks/common.py``
(``emit`` and the plan / config guards).  Its ``train_optimizer`` and
``auc`` are ported in ``train/driver.py``, which the benches use.
"""
from __future__ import annotations

import json
from typing import Dict

ROWS = []


def emit(name: str, us_per_call: float, derived: str) -> None:
    """The reference's contract: ``name,us_per_call,derived`` CSV."""
    row = f"{name},{us_per_call:.1f},{derived}"
    ROWS.append(row)
    print(row, flush=True)


def collect_plans(record, path="") -> Dict[str, dict]:
    """Every resolved-backend ``plan`` marker in a (nested) record, keyed by
    its path; walks dicts and lists."""
    plans: Dict[str, dict] = {}
    if isinstance(record, dict):
        if "plan" in record and isinstance(record["plan"], dict):
            plans[path or "<root>"] = record["plan"]
        for key, val in record.items():
            if key != "plan":
                plans.update(collect_plans(val, f"{path}/{key}" if path else key))
    elif isinstance(record, list):
        for i, val in enumerate(record):
            plans.update(collect_plans(val, f"{path}[{i}]"))
    return plans


def check_plans_agree(record, what: str = "BENCH record") -> Dict[str, dict]:
    """Refuse a record whose sub-records' plans (``Backend.describe``)
    differ, so CPU numbers never merge with card numbers, nor a fused sweep
    with a reference one.  Returns the collected plans."""
    plans = collect_plans(record)
    distinct = {json.dumps(p, sort_keys=True) for p in plans.values()}
    if len(distinct) > 1:
        detail = "\n".join(f"  {k}: {json.dumps(v, sort_keys=True)}" for k, v in sorted(plans.items()))
        raise ValueError(
            f"{what}: refusing to merge records with disagreeing backend plans:\n{detail}"
        )
    return plans


def collect_configs(record, path="") -> Dict[str, dict]:
    """Every ``config`` marker in a (nested) record, keyed by path."""
    configs: Dict[str, dict] = {}
    if isinstance(record, dict):
        if "config" in record and isinstance(record["config"], dict):
            configs[path or "<root>"] = record["config"]
        for key, val in record.items():
            if key != "config":
                configs.update(collect_configs(val, f"{path}/{key}" if path else key))
    elif isinstance(record, list):
        for i, val in enumerate(record):
            configs.update(collect_configs(val, f"{path}[{i}]"))
    return configs


def _flatten_config(cfg: dict, prefix: str = "") -> Dict[str, object]:
    flat: Dict[str, object] = {}
    for k, v in cfg.items():
        kk = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten_config(v, kk))
        else:
            flat[kk] = v
    return flat


def check_configs_agree(record, what: str = "BENCH record") -> Dict[str, dict]:
    """Refuse measurement configs that conflict: every ``config`` marker is
    flattened to dotted keys, and a key two markers share must have one
    value.  Keys in only one marker are fine."""
    configs = collect_configs(record)
    seen: Dict[str, tuple] = {}
    for path, cfg in sorted(configs.items()):
        for key, val in _flatten_config(cfg).items():
            vj = json.dumps(val, sort_keys=True)
            if key in seen and seen[key][1] != vj:
                raise ValueError(
                    f"{what}: refusing records with mismatched configs: "
                    f"'{key}' is {seen[key][1]} at {seen[key][0]} but {vj} "
                    f"at {path}"
                )
            seen.setdefault(key, (path, vj))
    return configs


def merge_bench_records(base: dict, **sub_records: dict) -> dict:
    """Merge sub-records into one record, refusing disagreeing ``plan``s
    (check_plans_agree) or conflicting ``config``s (check_configs_agree)."""
    merged = dict(base)
    merged.update(sub_records)
    check_plans_agree(merged, what="merge_bench_records")
    check_configs_agree(merged, what="merge_bench_records")
    return merged
