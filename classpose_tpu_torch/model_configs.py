"""Model configuration registry, YAML loader and download hooks
(counterpart of ``classpose_tpu/model_configs.py``).

The six built-in configs carry each published model's training MPP and
cell-type labels and point at its published ``.pt`` weights under
``CLASSPOSE_MODEL_DIR`` (read once, at import, as the JAX package reads
it). The port loads those ``.pt`` files as well as the JAX package's
native ``.npz`` checkpoints (``nn/convert.py``).

``ModelConfig`` is a dataclass, and :func:`parse_yaml` reads the subset
of YAML a config uses (scalars, the ``hf:`` mapping, the ``cell_types:``
list, in the block and flow styles ``yaml.safe_dump`` writes), so the
package needs neither pydantic nor PyYAML.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.utils import download_if_unavailable

logger = get_logger(__name__)

HOME = Path.home()
ROOT_MODEL_DIR = Path(os.getenv("CLASSPOSE_MODEL_DIR",
                                HOME / ".classpose_models"))
REPO_ID = "classpose/classpose"

# Built-in model registry: (training MPP, cell-type labels), the published
# model contract.
_BUILTIN_MODELS: dict[str, tuple[float, tuple[str, ...]]] = {
    "conic": (0.5, (
        "Neutrophil", "Epithelial", "Lymphocyte", "Plasma cell",
        "Eosinophil", "Connective",
    )),
    "consep": (0.25, (
        "Other", "Inflammatory", "Healthy epithelial",
        "Malignant epithelial", "Stroma", "Muscle",
    )),
    "glysac": (0.25, ("Other", "Lymphocyte", "Epithelial", "Ambiguous")),
    "monusac": (0.25, (
        "Epithelial", "Lymphocyte", "Macrophage", "Neutrophil",
    )),
    "nucls": (0.2, (
        "Tumor", "Stroma", "Lymphocyte", "Plasma cell", "Macrophage",
        "Other",
    )),
    "puma": (0.22, (
        "Apoptosis", "Tumor", "Endothelial", "Stroma", "Lymphocyte",
        "Histocyte", "Epithelial", "Melanophage", "Other",
    )),
}


def _builtin(name: str, mpp: float, cell_types: tuple[str, ...]) -> dict:
    return {
        "path": str(ROOT_MODEL_DIR / f"{name}.pt"),
        "mpp": mpp,
        "url": None,
        "hf": {"repo_id": REPO_ID, "filename": f"{name}.pt"},
        "cell_types": list(cell_types),
    }


DEFAULT_MODEL_CONFIGS: dict[str, dict] = {
    name: _builtin(name, mpp, types)
    for name, (mpp, types) in _BUILTIN_MODELS.items()
}


# ------------------------------------------------------------------ YAML

_BOOL = {**{k: True for k in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{k: False for k in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
# YAML 1.1 as PyYAML resolves it: a float needs a dot (1e-7 is a string)
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL = {".inf": float("inf"), "+.inf": float("inf"),
            "-.inf": float("-inf"), ".nan": float("nan")}


def _scalar(tok: str):
    tok = tok.strip()
    if tok.startswith("'"):
        if not tok.endswith("'") or len(tok) < 2:
            raise ValueError(f"unterminated quote: {tok}")
        return tok[1:-1].replace("''", "'")
    if tok.startswith('"'):
        if not tok.endswith('"') or len(tok) < 2:
            raise ValueError(f"unterminated quote: {tok}")
        return tok[1:-1].encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    if tok.startswith(("[", "{")):
        return _flow(tok)
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if tok.lower() in _SPECIAL:
        return _SPECIAL[tok.lower()]
    if _FLOAT.match(tok) and any(c.isdigit() for c in tok):
        return float(tok.replace("_", ""))
    return tok


def _split_top(body: str, sep: str) -> list[str]:
    """Split ``body`` at ``sep`` outside quotes and brackets."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def _key_value(item: str) -> tuple[str, str]:
    """``key: value`` split at the first ``: `` (or a trailing ``:``)
    outside quotes."""
    quote = None
    for i, ch in enumerate(item):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(item) or item[i + 1] in " \t"):
            return str(_scalar(item[:i])), item[i + 1:]
    raise ValueError(f"not a mapping entry: {item!r}")


def _flow(tok: str):
    body = tok[1:-1].strip()
    if tok[0] == "[" and tok[-1] == "]":
        return [_scalar(p) for p in _split_top(body, ",")] if body else []
    if tok[0] == "{" and tok[-1] == "}":
        out = {}
        for p in (_split_top(body, ",") if body else []):
            k, v = _key_value(p.strip())
            out[k] = _scalar(v)
        return out
    raise ValueError(f"bad flow collection: {tok}")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _open_brackets(s: str) -> int:
    """Brackets opened and not closed in ``s``, outside quotes."""
    depth, quote = 0, None
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        else:
            depth += (ch in "[{") - (ch in "]}")
    return depth


def parse_yaml(text: str):
    """The YAML subset of a model config: a mapping of scalars, flow
    collections (which may wrap over lines), and block lists or mappings
    one level deep."""
    lines = [(len(s) - len(s.lstrip(" ")), s.strip())
             for s in (_strip_comment(raw).rstrip()
                       for raw in text.splitlines())
             if s.strip() and s.strip() not in ("---", "...")]
    if lines and lines[0][1].startswith("{"):
        return _flow(" ".join(s for _, s in lines))
    out: dict = {}
    i = 0
    while i < len(lines):
        ind, s = lines[i]
        if ind != 0:
            raise ValueError(f"unexpected indentation: {s!r}")
        key, val = _key_value(s)
        i += 1
        while val.strip()[:1] in ("[", "{") and _open_brackets(val) > 0:
            val += " " + lines[i][1]
            i += 1
        if val.strip():
            out[key] = _scalar(val)
            continue
        block = []
        while i < len(lines) and (lines[i][0] > 0
                                  or lines[i][1].startswith("- ")
                                  or lines[i][1] == "-"):
            block.append(lines[i][1])
            i += 1
        if not block:
            out[key] = None
        elif block[0].startswith("-"):
            out[key] = [_scalar(b[1:]) for b in block]
        else:
            out[key] = {k: _scalar(v) for k, v in map(_key_value, block)}
    return out


# ---------------------------------------------------------------- configs

@dataclasses.dataclass
class HuggingFaceConfig:
    repo_id: str
    filename: str


@dataclasses.dataclass
class ModelConfig:
    """A Classpose model configuration: weights path, training MPP,
    download source, cell-type labels."""

    path: str
    mpp: float
    cell_types: list[str]
    url: str | None = None
    hf: HuggingFaceConfig | None = None

    def __post_init__(self):
        if isinstance(self.hf, dict):
            self.hf = HuggingFaceConfig(**self.hf)
        self.path = str(self.path)
        self.mpp = float(self.mpp)
        self.cell_types = [str(c) for c in self.cell_types]

    @staticmethod
    def load_from_yaml(path: str) -> "ModelConfig":
        logger.info(f"Loading model config from {path}")
        with open(path) as o:
            config = parse_yaml(o.read())
        return ModelConfig(**config)

    def download_if_necessary(self) -> None:
        if Path(self.path).exists():
            logger.info("Model weights already in %s", self.path)
            return
        logger.info("Downloading model weights to %s", self.path)
        if self.url is not None:
            download_if_unavailable(self.path, self.url)
        elif self.hf is not None:
            try:
                from huggingface_hub import hf_hub_download
            except ImportError as e:
                raise RuntimeError(
                    "huggingface_hub is required to download model weights; "
                    f"place the weights manually at {self.path}"
                ) from e
            kwargs = dict(repo_id=self.hf.repo_id, filename=self.hf.filename,
                          local_dir=str(Path(self.path).parent))
            hf_token = os.getenv("HF_TOKEN", None)
            if hf_token is not None:
                kwargs["token"] = hf_token
            hf_hub_download(**kwargs)
        else:
            raise FileNotFoundError(
                f"Model weights not found at {self.path} and no download "
                "source is configured."
            )


def resolve_model_config(name_or_path: str) -> ModelConfig:
    """A built-in config name or a YAML file path → ModelConfig."""
    if name_or_path in DEFAULT_MODEL_CONFIGS:
        return ModelConfig(**DEFAULT_MODEL_CONFIGS[name_or_path])
    if os.path.exists(name_or_path):
        return ModelConfig.load_from_yaml(name_or_path)
    raise ValueError(
        f"Unknown model config '{name_or_path}'. Built-ins: "
        f"{sorted(DEFAULT_MODEL_CONFIGS)} or pass a YAML path."
    )
