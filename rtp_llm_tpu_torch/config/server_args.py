"""Env-var + CLI dual flag parsing over the config dataclasses.

Port of ``rtp_llm_tpu/config/server_args.py``: every field of every group of
the port's ``EngineConfig`` (and its top-level fields) is exposed both as
``--<group>-<field-with-dashes>`` and as the env var ``RTP_<GROUP>_<FIELD>``.
The CLI wins over the env, the env over the default.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
import typing
from typing import Any, Optional

from rtp_llm_tpu_torch.config.engine_config import EngineConfig

ENV_PREFIX = "RTP"


def _parse_bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def _coerce(field_type: Any, raw: str) -> Any:
    origin = typing.get_origin(field_type)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        field_type = args[0] if args else str
        origin = typing.get_origin(field_type)
    if field_type is bool:
        return _parse_bool(raw)
    if field_type is int:
        return int(raw)
    if field_type is float:
        return float(raw)
    if origin is tuple or field_type is tuple:
        return tuple(int(x) for x in raw.split(","))
    if isinstance(field_type, type) and issubclass(field_type, enum.Enum):
        return field_type(raw)
    return raw


def iter_fields(cfg: EngineConfig):
    """Yield (group name, group object, field) for every flat config field
    (group name "" for the top-level fields)."""
    for group_name in EngineConfig.GROUPS:
        group = getattr(cfg, group_name)
        for f in dataclasses.fields(group):
            yield group_name, group, f
    for f in dataclasses.fields(EngineConfig):
        if f.name not in EngineConfig.GROUPS:
            yield "", cfg, f


def env_name(group: str, field: str) -> str:
    return "_".join([ENV_PREFIX] + ([group.upper()] if group else []) + [field.upper()])


def flag_name(group: str, field: str) -> str:
    base = f"{group}-{field}" if group else field
    return "--" + base.replace("_", "-")


def dest_name(group: str, field: str) -> str:
    return f"{group}.{field}" if group else field


def add_config_flags(parser: argparse.ArgumentParser, cfg: Optional[EngineConfig] = None) -> None:
    """Add ``--<group>-<field>`` (default None: not given) for every field;
    a flag the parser already has (an alias of the same name) is kept."""
    taken = {opt for a in parser._actions for opt in a.option_strings}
    for group_name, _group, f in iter_fields(cfg or EngineConfig()):
        flag = flag_name(group_name, f.name)
        if flag not in taken:
            parser.add_argument(flag, dest=dest_name(group_name, f.name), default=None,
                                help=f"(env: {env_name(group_name, f.name)})")


def build_parser(cfg: Optional[EngineConfig] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="rtp-llm-tpu-torch",
                                     description="LLM serving engine on one CUDA GPU")
    add_config_flags(parser, cfg)
    return parser


def _resolve_type(group: Any, name: str) -> Any:
    return typing.get_type_hints(type(group)).get(name, str)


def apply_env_and_args(cfg: EngineConfig, argv: Optional[list] = None,
                       namespace: Optional[argparse.Namespace] = None) -> EngineConfig:
    """Resolve each field: CLI flag > env var > the value ``cfg`` holds.
    ``namespace``: flags already parsed (by ``add_config_flags``' parser),
    in place of parsing ``argv``."""
    if namespace is None:
        namespace, _unknown = build_parser(cfg).parse_known_args(argv)
    for group_name, group, f in iter_fields(cfg):
        raw = os.environ.get(env_name(group_name, f.name))
        cli = getattr(namespace, dest_name(group_name, f.name), None)
        if cli is not None:
            raw = cli
        if raw is None:
            continue
        ftype = f.type if not isinstance(f.type, str) else _resolve_type(group, f.name)
        setattr(group, f.name, _coerce(ftype, raw))
    return revalidate(cfg)


def revalidate(cfg: EngineConfig) -> EngineConfig:
    """Build each group again from its fields, so that its ``__post_init__``
    checks (and converts) the values set on it."""
    for name in EngineConfig.GROUPS:
        group = getattr(cfg, name)
        setattr(cfg, name, type(group)(**{f.name: getattr(group, f.name)
                                          for f in dataclasses.fields(group)}))
    return cfg


def parse_engine_config(argv: Optional[list] = None) -> EngineConfig:
    return apply_env_and_args(EngineConfig(), argv)
