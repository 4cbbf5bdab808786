"""Typed flag / configuration system.

Parity: the reference declares typed flags at point of use with
DSN_DEFINE_{int32,bool,string,...} (src/utils/flags.h:66-89), loads values
from ini config sections (src/utils/configuration.*), supports validators
and runtime mutation of FT_MUTABLE-tagged flags. We keep the same shape:
`define_flag(section, name, default, ...)` registers, `load_config` fills
from an ini file, `FLAGS.get/set` read and mutate.
"""

from __future__ import annotations

import configparser
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass
class _Flag:
    section: str
    name: str
    value: Any
    default: Any
    type: type
    description: str = ""
    mutable: bool = False
    validator: Optional[Callable[[Any], bool]] = None


class FlagRegistry:
    def __init__(self) -> None:
        self._flags: Dict[Tuple[str, str], _Flag] = {}
        self._lock = threading.Lock()

    def define(
        self,
        section: str,
        name: str,
        default: Any,
        description: str = "",
        mutable: bool = False,
        validator: Optional[Callable[[Any], bool]] = None,
    ) -> None:
        key = (section, name)
        with self._lock:
            if key in self._flags:
                return
            self._flags[key] = _Flag(
                section=section,
                name=name,
                value=default,
                default=default,
                type=type(default),
                description=description,
                mutable=mutable,
                validator=validator,
            )

    def get(self, section: str, name: str) -> Any:
        return self._flags[(section, name)].value

    def set(self, section: str, name: str, value: Any, force: bool = False) -> None:
        flag = self._flags[(section, name)]
        if not flag.mutable and not force:
            raise ValueError(f"flag [{section}]{name} is not mutable")
        value = _coerce(value, flag.type)
        if flag.validator is not None and not flag.validator(value):
            raise ValueError(f"invalid value for [{section}]{name}: {value!r}")
        flag.value = value

    def load_ini(self, path: str) -> None:
        parser = configparser.ConfigParser()
        parser.read(path)
        with self._lock:
            for (section, name), flag in self._flags.items():
                if parser.has_option(section, name):
                    raw = parser.get(section, name)
                    value = _coerce(raw, flag.type)
                    if flag.validator is not None and not flag.validator(value):
                        raise ValueError(
                            f"invalid config value for [{section}]{name}: {raw!r}"
                        )
                    flag.value = value


def _coerce(value: Any, typ: type) -> Any:
    if isinstance(value, typ):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    return typ(value)


FLAGS = FlagRegistry()


def define_flag(section: str, name: str, default: Any, description: str = "",
                mutable: bool = False,
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    FLAGS.define(section, name, default, description, mutable, validator)


def load_config(path: str) -> None:
    FLAGS.load_ini(path)
