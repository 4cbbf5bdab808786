"""Reliable tree-structured KV for cluster metadata.

Parity: src/meta/meta_state_service.h:56 (interface) with the
`meta_state_service_simple` local implementation (the ZK-free test/onebox
backend, src/meta/meta_state_service_simple.h) — node paths like
/apps/<id>/<pidx> with JSON values, persisted atomically to one file.
A ZooKeeper-backed implementation slots in behind the same interface for
multi-meta deployments.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional


class MetaStorage:
    def __init__(self, path: str) -> None:
        self.path = path
        self._tree: Dict[str, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._tree = json.load(f)

    def _persist(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._tree, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def set(self, node: str, value: Any) -> None:
        self._tree[node] = value
        self._persist()

    def set_batch(self, updates: Dict[str, Any]) -> None:
        """Many nodes, one persisted write+fsync (DDL writes an app plus
        all its partitions; per-node persists would be O(partitions)
        full-file fsyncs)."""
        self._tree.update(updates)
        self._persist()

    def get(self, node: str) -> Optional[Any]:
        return self._tree.get(node)

    def delete(self, node: str) -> None:
        removed = False
        for key in [k for k in self._tree
                    if k == node or k.startswith(node + "/")]:
            del self._tree[key]
            removed = True
        if removed:
            self._persist()

    def children(self, node: str) -> List[str]:
        prefix = node.rstrip("/") + "/"
        out = set()
        for key in self._tree:
            if key.startswith(prefix):
                out.add(key[len(prefix):].split("/")[0])
        return sorted(out)
