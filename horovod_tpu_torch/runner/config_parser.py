"""YAML config file to launcher arguments and worker knobs (port of
``horovod_tpu/runner/config_parser.py``): a YAML file can set every
launcher argument and runtime knob; flags given on the command line win
over the file.
"""

from __future__ import annotations

from ..utils import envs

# top-level scalar keys → argparse dest names
_ARG_KEYS = {
    "verbose": "verbose",
    "np": "np",
    "hosts": "hosts",
    "hostfile": "hostfile",
    "min-np": "min_np",
    "max-np": "max_np",
    "host-discovery-script": "host_discovery_script",
    "ssh-port": "ssh_port",
    "ssh-identity-file": "ssh_identity_file",
    "start-timeout": "start_timeout",
    "output-filename": "output_filename",
    "coordinator-port": "coordinator_port",
    "slots-per-host": "slots_per_host",
}

# params section → env knob names (values in natural units)
_PARAM_KEYS = {
    "fusion-threshold-mb": (envs.FUSION_THRESHOLD, lambda v: int(v) * 1024 * 1024),
    "cycle-time-ms": (envs.CYCLE_TIME, float),
    "cache-capacity": (envs.CACHE_CAPACITY, int),
    "hierarchical-allreduce": (envs.HIERARCHICAL_ALLREDUCE, lambda v: int(bool(v))),
    "hierarchical-allgather": (envs.HIERARCHICAL_ALLGATHER, lambda v: int(bool(v))),
}

_TIMELINE_KEYS = {
    "filename": (envs.TIMELINE, str),
    "mark-cycles": (envs.TIMELINE_MARK_CYCLES, lambda v: int(bool(v))),
}

_AUTOTUNE_KEYS = {
    "enabled": (envs.AUTOTUNE, lambda v: int(bool(v))),
    "log-file": (envs.AUTOTUNE_LOG, str),
    "warmup-samples": (envs.AUTOTUNE_WARMUP_SAMPLES, int),
    "steps-per-sample": (envs.AUTOTUNE_STEPS_PER_SAMPLE, int),
    "bayes-opt-max-samples": (envs.AUTOTUNE_BAYES_OPT_MAX_SAMPLES, int),
    "gaussian-process-noise": (envs.AUTOTUNE_GAUSSIAN_PROCESS_NOISE, float),
}

_STALL_KEYS = {
    "check-disable": (envs.STALL_CHECK_DISABLE, lambda v: int(bool(v))),
    "check-time-seconds": (envs.STALL_CHECK_TIME_SECONDS, float),
    "shutdown-time-seconds": (envs.STALL_SHUTDOWN_TIME_SECONDS, float),
}

_SECTIONS = {
    "params": _PARAM_KEYS,
    "timeline": _TIMELINE_KEYS,
    "autotune": _AUTOTUNE_KEYS,
    "stall-check": _STALL_KEYS,
}


def load_config(path: str) -> dict:
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"config file {path} must contain a mapping")
    return cfg


def apply_config_to_args(cfg: dict, args, explicit_dests: set) -> None:
    """Set argparse namespace fields from the config unless given on the
    command line."""
    for key, dest in _ARG_KEYS.items():
        if key in cfg and dest not in explicit_dests:
            setattr(args, dest, cfg[key])


def config_to_env(cfg: dict) -> dict[str, str]:
    """Translate knob sections to HVD_* env assignments."""
    env: dict[str, str] = {}
    for section, keymap in _SECTIONS.items():
        body = cfg.get(section) or {}
        if not isinstance(body, dict):
            raise ValueError(f"config section {section!r} must be a mapping")
        for key, val in body.items():
            if key not in keymap:
                raise ValueError(f"unknown key {key!r} in section {section!r}")
            env_name, conv = keymap[key]
            env["HVD_" + env_name] = str(conv(val))
    return env
