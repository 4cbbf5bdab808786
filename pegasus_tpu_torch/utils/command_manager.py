"""Remote command registry: runtime control verbs.

Parity: src/utils/command_manager.h:52,137 — components register named
verbs with handlers; operators invoke them remotely (the reference rides
RPC_CLI_CLI_CALL, src/remote_cmd/remote_command.cpp:41-68; here the
verbs are reachable as a "remote_command" cluster message and through
the HTTP /command endpoint), and the shell's remote_command verb
(commands.h:111) fronts them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class CommandManager:
    def __init__(self) -> None:
        self._verbs: Dict[str, Dict[str, Any]] = {}

    def register(self, verb: str,
                 handler: Callable[[List[str]], Any],
                 help_text: str = "") -> None:
        if verb in self._verbs:
            raise ValueError(f"command {verb!r} already registered")
        self._verbs[verb] = {"handler": handler, "help": help_text}

    def deregister(self, verb: str) -> None:
        self._verbs.pop(verb, None)

    def call(self, verb: str, args: List[str]) -> Any:
        if verb == "help":
            return {v: info["help"] for v, info in sorted(
                self._verbs.items())}
        info = self._verbs.get(verb)
        if info is None:
            raise KeyError(f"unknown command {verb!r} "
                           f"(try 'help')")
        return info["handler"](list(args))

    def verbs(self) -> List[str]:
        return sorted(self._verbs)
