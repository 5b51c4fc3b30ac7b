"""Hardware factory: HARDWARE_TYPE -> semantic-table builder.

The counterpart of avida_tpu/models/registry.py (the cHardwareManager
factory, avida-core/source/cpu/cHardwareManager.cc:123-147).  Each entry
maps a hardware type id to a module exposing
`build_semantic_tables(inst_names)` plus its default instruction-set file
name.
"""

from avida_tpu_torch.models import experimental, heads, transsmt

HARDWARE_REGISTRY = {
    0: {"name": "heads", "module": heads,
        "default_instset": "instset-heads.cfg"},
    # reference numbering (core/Definitions.h eHARDWARE_TYPE): transsmt is
    # HARDWARE_TYPE 1 in the enum but instset files declare hw_type=2
    # (cHardwareManager::loadInstSet switch) -- accept both
    1: {"name": "transsmt", "module": transsmt,
        "default_instset": "instset-transsmt.cfg"},
    2: {"name": "transsmt", "module": transsmt,
        "default_instset": "instset-transsmt.cfg"},
    3: {"name": "experimental", "module": experimental,
        "default_instset": "instset-experimental.cfg"},
}


def get_hardware(hw_type: int):
    if hw_type not in HARDWARE_REGISTRY:
        raise ValueError(
            f"HARDWARE_TYPE {hw_type} not supported yet "
            f"(available: {sorted(HARDWARE_REGISTRY)})")
    return HARDWARE_REGISTRY[hw_type]
