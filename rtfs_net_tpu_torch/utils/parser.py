"""Config/CLI round-trip (``rtfs_net_tpu/utils/parser.py``, copied; reference:
``src/utils/parser_utils.py``).

Behavioral contract: a two-level YAML config becomes argparse groups whose
leaves are CLI-overridable; ``parse_args_as_dict`` reassembles the nested
dict with non-grouped args collected under ``main_args``. Only the
*shallow* (depth<=2) leaves are exposed as flags, exactly like the
reference — deeper audionet sub-dicts pass through untouched.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional


def str2bool(value):
    if not isinstance(value, str):
        return value
    if value.lower() in ("yes", "true", "y", "1"):
        return True
    if value.lower() in ("no", "false", "n", "0"):
        return False
    return value


def str2bool_arg(value):
    value = str2bool(value)
    if isinstance(value, bool):
        return value
    raise argparse.ArgumentTypeError("Boolean value expected.")


def str_int_float(value):
    try:
        return int(value)
    except (TypeError, ValueError):
        pass
    try:
        return float(value)
    except (TypeError, ValueError):
        pass
    return value


def _entry_type(value):
    if value is None:
        return str_int_float
    if isinstance(str2bool(value), bool):
        return str2bool_arg
    return type(value)


def prepare_parser_from_dict(dic: Dict[str, Any],
                             parser: Optional[argparse.ArgumentParser] = None):
    """Build an argparser with one group per top-level key and one flag per
    second-level leaf (default = config value)."""
    if parser is None:
        parser = argparse.ArgumentParser()
    for k, v in dic.items():
        group = parser.add_argument_group(k)
        if isinstance(v, dict):
            for kk, vv in v.items():
                if isinstance(vv, dict):
                    # deep sub-config (audionet blocks): not CLI-exposed,
                    # carried through parse_args_as_dict via defaults
                    group.add_argument(f"--{kk}", default=vv, type=_passthrough)
                else:
                    group.add_argument(f"--{kk}", default=vv, type=_entry_type(vv))
        else:
            group.add_argument(f"--{k}", default=v, type=_entry_type(v))
    return parser


def _passthrough(value):
    return value


def parse_args_as_dict(parser, return_plain_args: bool = False, args=None):
    """parser.parse_args() -> {group: {arg: value}}, plus ``main_args`` for
    ungrouped args."""
    parsed = parser.parse_args(args=args)
    out: Dict[str, Any] = {}
    for group in parser._action_groups:
        group_dict = {a.dest: getattr(parsed, a.dest, None) for a in group._group_actions}
        out[group.title] = group_dict
    default_group = "options" if sys.version_info.minor >= 10 else "optional arguments"
    out["main_args"] = out.pop(default_group)
    out["main_args"].pop("help", None)
    if return_plain_args:
        return out, parsed
    return out
