"""Host utilities of the port: the config parser (exported here), and in
their modules ``separate``, the JAX-variables converter, feature chunking
(``features``), parameter and MAC counts (``flops``) and timing
(``profiling``). This
``__init__`` imports no torch: the training entry point imports it, and
the data loader's spawned workers import that entry point again."""
from .parser import (
    prepare_parser_from_dict,
    parse_args_as_dict,
    str2bool,
    str2bool_arg,
    str_int_float,
)

__all__ = [
    "prepare_parser_from_dict",
    "parse_args_as_dict",
    "str2bool",
    "str2bool_arg",
    "str_int_float",
]
