"""MultivariateCache: a 2D coefficient cache keyed by an EngineContext.
Counterpart of `aesfhe_tpu/coeffs/cache.py`."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

from ..context import EngineContext
from ..core.ciphertext import ScalarPlaintext


class MultivariateCache:
    def __init__(self, path: Path, ctx: EngineContext):
        self.path = Path(path)
        self.ctx = ctx
        self._coeffs = None

    def load_coeffs(self) -> Dict[Tuple[int, int], complex]:
        if self._coeffs is None:
            data = json.loads(self.path.read_text(encoding="utf-8"))
            self._coeffs = {(int(i), int(j)): complex(re, im)
                            for i, j, re, im in data["entries"]}
        return self._coeffs

    def get_plaintext_coeffs(self) -> Dict[Tuple[int, int], ScalarPlaintext]:
        scale = self.ctx.engine.params.scale
        return {k: ScalarPlaintext(v, scale)
                for k, v in self.load_coeffs().items()}
