"""Layered configuration system.

API-compatible with the reference Config (heimdall/core/config.py:10-300):
defaults → file (YAML/JSON) deep-merge, dot-path get/set, per-camera and
per-station lookups that merge "default" entries, add_camera/add_station,
save/load round-trip.  Defaults preserve the reference's documented values
(production_speed 90000 BPH, rejection_threshold 0.7, PLC modbus defaults —
config.py:27,43-44,50-61) and add a ``tpu`` section for the device runtime.

A copy of heimdall_tpu/core/config.py: the port imports
nothing of the JAX package.
"""

import copy
import json
import logging
import os
from typing import Any, Dict, Optional

import yaml

logger = logging.getLogger("heimdall.config")

_DEFAULTS: Dict[str, Any] = {
    "system": {
        "name": "Heimdall TPU",
        "version": "0.1.0",
        "log_level": "INFO",
        "machine_type": "SBO",
        "production_speed": 90000,  # bottles per hour
    },
    "cameras": {
        "default": {
            "type": "simulation",
            "width": 1280,
            "height": 720,
            "fps": 30,
        }
    },
    "inspection": {
        "default": {
            "pipeline": "basic",
            "save_images": False,
            "rejection_threshold": 0.7,
            "min_defect_size": 5,
        }
    },
    "stations": {},
    "communication": {
        "plc": {
            "enabled": False,
            "protocol": "modbus",
            "ip": "192.168.1.100",
            "port": 502,
        },
        "rejection": {
            "delay_ms": 100,
            "pulse_duration_ms": 50,
        },
    },
    "ui": {
        "theme": "dark",
        "window_width": 1280,
        "window_height": 800,
        "update_interval_ms": 100,
    },
    "paths": {
        "logs": "./logs",
        "images": "./images",
        "results": "./results",
        "models": "./models",
    },
    "performance": {
        "cpu_monitoring": True,
        "memory_monitoring": True,
        "processing_time_monitoring": True,
    },
    "debug": {
        "enabled": True,
        "save_debug_images": True,
        "verbose_logging": True,
    },
    # TPU-native runtime knobs (new in this framework).
    "tpu": {
        "batch_size": 32,           # frames per device step
        "max_blobs": 64,            # blob-table capacity per frame
        "mesh": {"data": -1, "spatial": 1},  # -1 = all remaining devices
        "donate_buffers": True,
        "precision": "int_exact",   # int_exact | fast_bf16
    },
}


class Config:
    """Deep-merging dict config with dot-path access (YAML/JSON backed)."""

    def __init__(self, config_path: Optional[str] = None):
        self.config_path = config_path
        self.config: Dict[str, Any] = copy.deepcopy(_DEFAULTS)
        if config_path is not None:
            self.load_config(config_path)

    # -- file I/O ---------------------------------------------------------
    def load_config(self, config_path: str) -> bool:
        if not os.path.exists(config_path):
            logger.warning("Configuration file not found: %s", config_path)
            return False
        try:
            ext = os.path.splitext(config_path)[1].lower()
            with open(config_path, "r") as f:
                if ext in (".yml", ".yaml"):
                    file_config = yaml.safe_load(f)
                elif ext == ".json":
                    file_config = json.load(f)
                else:
                    logger.error("Unsupported config format: %s", ext)
                    return False
            if file_config:
                _deep_update(self.config, file_config)
            logger.info("Loaded configuration from: %s", config_path)
            return True
        except Exception as exc:  # pragma: no cover - defensive
            logger.error("Failed to load configuration: %s", exc)
            return False

    def save_config(self, config_path: Optional[str] = None) -> bool:
        save_path = config_path or self.config_path
        if save_path is None:
            logger.error("No configuration path specified")
            return False
        try:
            parent = os.path.dirname(save_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            ext = os.path.splitext(save_path)[1].lower()
            with open(save_path, "w") as f:
                if ext in (".yml", ".yaml"):
                    yaml.dump(self.config, f, default_flow_style=False)
                elif ext == ".json":
                    json.dump(self.config, f, indent=2)
                else:
                    logger.error("Unsupported config format: %s", ext)
                    return False
            logger.info("Saved configuration to: %s", save_path)
            return True
        except Exception as exc:  # pragma: no cover - defensive
            logger.error("Failed to save configuration: %s", exc)
            return False

    # -- mutation ---------------------------------------------------------
    def add_camera(self, camera_id: str, config: Dict[str, Any]) -> None:
        self.config.setdefault("cameras", {})[camera_id] = config

    def add_station(self, station_id: str, config: Dict[str, Any]) -> None:
        self.config.setdefault("stations", {})[station_id] = config

    # -- dot-path access --------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        current = self.config
        for part in key.split("."):
            if not isinstance(current, dict) or part not in current:
                return default
            current = current[part]
        return current

    def set(self, key: str, value: Any) -> None:
        parts = key.split(".")
        current = self.config
        for part in parts[:-1]:
            current = current.setdefault(part, {})
        current[parts[-1]] = value

    # -- merged lookups ---------------------------------------------------
    def get_camera_config(self, camera_id: str) -> Dict[str, Any]:
        cameras = self.config.get("cameras", {})
        result = dict(cameras.get("default", {}))
        result.update(cameras.get(camera_id, {}))
        return result

    def get_station_config(self, station_id: str) -> Dict[str, Any]:
        default = self.config.get("inspection", {}).get("default", {})
        result = dict(default)
        result.update(self.config.get("stations", {}).get(station_id, {}))
        return result

    def get_all_cameras(self) -> Dict[str, Dict[str, Any]]:
        cameras = dict(self.config.get("cameras", {}))
        cameras.pop("default", None)
        return cameras

    def get_all_stations(self) -> Dict[str, Dict[str, Any]]:
        return dict(self.config.get("stations", {}))


def _deep_update(target: Dict[str, Any], source: Dict[str, Any]) -> None:
    for key, value in source.items():
        if (isinstance(value, dict) and isinstance(target.get(key), dict)):
            _deep_update(target[key], value)
        else:
            target[key] = value
