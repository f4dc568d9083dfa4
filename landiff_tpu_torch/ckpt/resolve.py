"""Checkpoint discovery and verification (the port's own copy of
landiff_tpu/ckpt/resolve.py).

Re-creates the reference bootstrap (landiff/utils.py:23-217):
  1. resolve model dir: LANDIFF_HOME env -> <repo>/ckpts/LanDiff; the
     reference's last step, a hub download of "yinaoxiong/LanDiff", is not
     taken: the port makes no network call, so without a local tree it
     raises and names the local paths it looked at
  2. MD5-verify files against ckpts/CHECKSUM.md5
  3. symlink the resolved dir to <repo>/ckpts/LanDiff for stable paths

Env kill-switches (reference landiff/__init__.py:14-29):
  LANDIFF_SKIP_INIT=1        skip the whole bootstrap
  LANDIFF_SKIP_HASH_CHECK=1  skip MD5 verification
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path

logger = logging.getLogger("landiff_tpu_torch.ckpt")

_MODEL_PATH: Path | None = None

HF_REPO_ID = "yinaoxiong/LanDiff"


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def parse_md5_manifest(checksum_file: Path) -> dict[str, str]:
    """Parse a `md5sum`-format manifest: '<md5>  ./rel/path' per line."""
    checksums: dict[str, str] = {}
    for line in checksum_file.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        md5, filepath = line.split("  ", 1)
        if filepath.startswith("./"):
            filepath = filepath[2:]
        checksums[filepath] = md5
    return checksums


def md5_file(path: Path, chunk_size: int = 4096 * 256) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_md5_checksum(root_dir: Path,
                        checksum_file: Path | None = None) -> bool:
    """Verify every file in the manifest exists under root_dir with a
    matching MD5 (reference utils.py:23-90)."""
    if checksum_file is None:
        checksum_file = _repo_root() / "ckpts" / "CHECKSUM.md5"
        if not checksum_file.exists():
            # fall back to a manifest shipped inside the model dir itself
            checksum_file = root_dir / "CHECKSUM.md5"
    if not checksum_file.exists():
        raise FileNotFoundError(f"Checksum file does not exist: {checksum_file}")
    for rel_path, expected in parse_md5_manifest(checksum_file).items():
        file_path = root_dir / rel_path
        if not file_path.exists():
            logger.error("missing checkpoint file: %s", file_path)
            return False
        actual = md5_file(file_path)
        if actual != expected:
            logger.error("MD5 mismatch for %s: expected %s got %s",
                         file_path, expected, actual)
            return False
    return True


def _symlink_workspace(model_path: Path, workspace_path: Path) -> None:
    if model_path == workspace_path:
        return
    if workspace_path.exists() and not workspace_path.is_symlink():
        raise FileExistsError(
            f"Workspace path '{workspace_path}' exists and is not a symlink; "
            f"remove it to link the model path '{model_path}'.")
    if workspace_path.is_symlink():
        workspace_path.unlink()
    workspace_path.parent.mkdir(parents=True, exist_ok=True)
    workspace_path.symlink_to(model_path, target_is_directory=True)
    logger.info("linked %s -> %s", workspace_path, model_path)


def initialize_landiff_model_path(skip_hash_verification: bool | None = None) -> Path:
    """Resolve, verify and cache the LanDiff checkpoint directory."""
    global _MODEL_PATH
    if _MODEL_PATH is not None:
        return _MODEL_PATH
    if skip_hash_verification is None:
        skip_hash_verification = os.environ.get(
            "LANDIFF_SKIP_HASH_CHECK", "0") == "1"

    workspace_path = _repo_root() / "ckpts" / "LanDiff"
    candidates: list[Path] = []
    env_path = os.environ.get("LANDIFF_HOME")
    if env_path:
        candidates.append(Path(env_path))
    candidates.append(workspace_path)

    for model_path in candidates:
        if model_path.exists() and model_path.is_dir():
            if skip_hash_verification or verify_md5_checksum(model_path):
                _MODEL_PATH = model_path
                _symlink_workspace(model_path, workspace_path)
                return model_path

    raise FileNotFoundError(
        "no verified LanDiff checkpoint tree at "
        + " or ".join(str(p) for p in candidates)
        + f"; the port does not download {HF_REPO_ID} from the hub: put a "
        "converted tree there, or set LANDIFF_HOME to one")


def initialize_model_path(required: bool = False) -> str | None:
    """The checkpoint directory as a string (landiff_tpu/__init__.py's
    initialize_model_path): None, with a warning, where no verified local
    tree is found, unless `required`."""
    try:
        return str(initialize_landiff_model_path())
    except Exception as e:   # the reference degrades (__init__.py:40-46)
        if required:
            raise
        logger.warning("landiff checkpoint bootstrap failed: %s", e)
        return None
