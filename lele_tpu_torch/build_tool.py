"""model.toml-driven build step of the port (the counterpart of
lele_tpu/build_tool.py): acquire → compile → generate, with
stub-on-failure.

- `ModelConfig`: [model] source = "hf-hub" | "url" | "local", repo/files
  (a plain string list or [[model.files]] tables with file/path and dest)
  or url or path; [codegen] class_name / model_file / input_shapes /
  dim_values / quantize = "dynamic" (onnx/quantize.py on the acquired float
  model before compiling)
- downloads honour HF_ENDPOINT and cache under LELE_MODEL_CACHE
- the compile is lele_tpu_torch.cli.compile_to_dir, on the card unless
  `--device cpu` (device="cpu") is given
- on any failure a stub wrapper is written, so a build never breaks
- LELE_SKIP_MODEL_GEN, LELE_FORCE_REGENERATE / LELE_FORCE_REGEN, and an
  mtime staleness check

    python -m lele_tpu_torch.build_tool <model.toml> <out_dir> [--device cpu]
"""

from __future__ import annotations

import os
import sys
import tomllib
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ModelConfig:
    source: str = "local"  # hf-hub | url | local
    repo: str = ""
    revision: str = "main"
    files: list[dict] = field(default_factory=list)  # [{file|path, dest}]
    url: str = ""
    path: str = ""
    class_name: str = "Model"
    model_file: str = ""
    custom_methods: list[str] = field(default_factory=list)
    input_shapes: dict = field(default_factory=dict)
    dim_values: dict = field(default_factory=dict)
    quantize: str = ""  # "" | "dynamic" (onnx/quantize.py at build time)

    @classmethod
    def load(cls, path: str | Path) -> "ModelConfig":
        raw = tomllib.loads(Path(path).read_text())
        model = raw.get("model", {})
        codegen = raw.get("codegen", {})
        files = []
        for f in model.get("files", []):
            # both schemas: plain string list, or [[model.files]] tables with
            # file/path + optional dest
            if isinstance(f, str):
                files.append({"file": f, "dest": f})
            else:
                name = f.get("file") or f.get("path", "")
                files.append({"file": name, "dest": f.get("dest", name)})
        return cls(
            source=model.get("source", "local"),
            repo=model.get("repo", ""),
            revision=model.get("revision", "main"),
            files=files,
            url=model.get("url", ""),
            path=model.get("path", ""),
            class_name=codegen.get("class_name", "Model"),
            model_file=codegen.get("model_file", ""),
            custom_methods=codegen.get("custom_methods", []),
            input_shapes={
                k: tuple(v) for k, v in codegen.get("input_shapes", {}).items()
            },
            dim_values=codegen.get("dim_values", {}),
            quantize=codegen.get("quantize", ""),
        )


def model_cache_dir() -> Path:
    d = Path(os.environ.get("LELE_MODEL_CACHE", Path.home() / ".cache/lele_tpu"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def should_skip_codegen() -> bool:
    return os.environ.get("LELE_SKIP_MODEL_GEN", "") not in ("", "0")


def force_regenerate() -> bool:
    return any(
        os.environ.get(k, "") not in ("", "0")
        for k in ("LELE_FORCE_REGENERATE", "LELE_FORCE_REGEN")
    )


def need_regenerate(model_path: Path, out_file: Path) -> bool:
    """mtime staleness."""
    if force_regenerate():
        return True
    if not out_file.exists():
        return True
    if model_path.exists() and model_path.stat().st_mtime > out_file.stat().st_mtime:
        return True
    return False


def download_from_hf_hub(
    repo: str, filename: str, dest: Path, revision: str = "main"
) -> Path:
    """HF Hub download honoring HF_ENDPOINT."""
    endpoint = os.environ.get("HF_ENDPOINT", "https://huggingface.co")
    url = f"{endpoint}/{repo}/resolve/{revision}/{filename}"
    return _download_url(url, dest)


def _download_url(url: str, dest: Path, timeout: float = 30.0) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
        while True:
            buf = r.read(1 << 20)
            if not buf:
                break
            f.write(buf)
    tmp.rename(dest)
    return dest


_STUB_TEMPLATE = '''"""STUB generated by lele_tpu_torch.build_tool — model acquisition or
compilation failed; this placeholder keeps imports working.

Reason: {reason}
"""


class {class_name}:
    STUB = True

    def __init__(self, *a, **k):
        raise RuntimeError(
            "model {class_name} is a stub: {reason}. "
            "Fix model.toml / network access and rerun the build."
        )

    forward = __init__
'''


def generate_stub(out_dir: Path, class_name: str, reason: str) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{class_name}.py"
    # sanitize to one plain line: the reason lands inside a generated string
    # literal, and a raw newline/backslash from an arbitrary exception text
    # would make the STUB itself a SyntaxError — the one failure mode a
    # stub exists to prevent
    clean = " ".join(str(reason).split()).replace("\\", "/").replace('"', "'")
    path.write_text(
        _STUB_TEMPLATE.format(class_name=class_name, reason=clean)
    )
    return path


def build_model(toml_path: str | Path, out_dir: str | Path,
                device: str | None = None) -> Path:
    """config → acquire → (re)generate on `device` (the card by default) →
    stub on failure. Returns the generated wrapper path (real or stub)."""
    from .cli import compile_to_dir, sanitize_name

    out_dir = Path(out_dir)
    cfg = ModelConfig.load(toml_path)
    cls = sanitize_name(cfg.class_name)
    if should_skip_codegen():
        print("LELE_SKIP_MODEL_GEN set; skipping", file=sys.stderr)
        return out_dir / f"{cls}.py"
    try:
        if cfg.source == "local":
            local = cfg.path or cfg.model_file or (
                cfg.files[0]["file"] if cfg.files else ""
            )
            model_path = Path(local)
            if not model_path.is_absolute():
                model_path = Path(toml_path).parent / model_path
        elif cfg.source == "hf-hub":
            cache = model_cache_dir() / cfg.repo.replace("/", "__")
            primary = cfg.model_file or (
                cfg.files[0]["dest"] if cfg.files else "model.onnx"
            )
            model_path = cache / primary
            for entry in cfg.files or [{"file": primary, "dest": primary}]:
                dest = cache / entry["dest"]
                if not dest.exists() or force_regenerate():
                    download_from_hf_hub(cfg.repo, entry["file"], dest,
                                         cfg.revision)
        elif cfg.source == "url":
            model_path = model_cache_dir() / Path(cfg.url).name
            if not model_path.exists() or force_regenerate():
                _download_url(cfg.url, model_path)
        else:
            raise ValueError(f"unknown source {cfg.source!r}")

        out_file = out_dir / f"{cls}.py"
        if not need_regenerate(model_path, out_file):
            return out_file
        if not model_path.exists():
            raise FileNotFoundError(model_path)
        if cfg.quantize:
            if cfg.quantize != "dynamic":
                raise ValueError(
                    f"codegen.quantize={cfg.quantize!r}: only 'dynamic' is "
                    "supported (onnxruntime quantize_dynamic analog)"
                )
            from .onnx.quantize import quantize_dynamic_file

            out_dir.mkdir(parents=True, exist_ok=True)
            qpath = out_dir / f"{model_path.stem}.int8.onnx"
            if need_regenerate(model_path, qpath):
                quantize_dynamic_file(str(model_path), str(qpath))
            model_path = qpath
        return compile_to_dir(
            str(model_path),
            str(out_dir),
            cls,
            input_shapes=cfg.input_shapes or None,
            dim_values=cfg.dim_values or None,
            device=device,
        )
    except Exception as e:  # stub-on-failure: the build never breaks
        print(f"build_model failed ({type(e).__name__}: {e}); writing stub",
              file=sys.stderr)
        return generate_stub(out_dir, cls, f"{type(e).__name__}: {e}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="lele_tpu_torch.build_tool")
    ap.add_argument("toml", help="model.toml path")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default=None,
                    help="torch device to compile on (default: the card)")
    args = ap.parse_args(argv)
    path = build_model(args.toml, args.out_dir, device=args.device)
    print(f"generated {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
