from avida_tpu_torch.config.schema import AvidaConfig, load_avida_cfg
from avida_tpu_torch.config.instset import (InstSet, load_instset,
                                            default_instset,
                                            heads_sex_instset,
                                            transsmt_instset)
from avida_tpu_torch.config.organism import load_organism
from avida_tpu_torch.config.environment import Environment, load_environment
from avida_tpu_torch.config.events import Event, load_events

__all__ = [
    "AvidaConfig", "load_avida_cfg",
    "InstSet", "load_instset", "default_instset", "heads_sex_instset",
    "transsmt_instset",
    "load_organism",
    "Environment", "load_environment",
    "Event", "load_events",
]
