"""Hardware factory: HARDWARE_TYPE -> semantic-table builder.

The counterpart of avida_tpu/models/registry.py (the cHardwareManager
factory, avida-core/source/cpu/cHardwareManager.cc:123-147).  Each entry
maps a hardware type id to a module exposing
`build_semantic_tables(inst_names)` plus its default instruction-set file
name.  The experimental spatial hardware (type 3) is not ported and is
refused by name.
"""

from avida_tpu_torch.models import heads, transsmt

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
}

# hardware the reference runs and this package does not yet
_UNPORTED = {
    3: "experimental spatial hardware (ROADMAP.md Queue 1 item 12h)",
}


def get_hardware(hw_type: int):
    if hw_type in _UNPORTED:
        raise NotImplementedError(
            f"HARDWARE_TYPE {hw_type}: {_UNPORTED[hw_type]} is not ported "
            f"to avida_tpu_torch")
    if hw_type not in HARDWARE_REGISTRY:
        raise ValueError(
            f"HARDWARE_TYPE {hw_type} not supported yet "
            f"(available: {sorted(HARDWARE_REGISTRY)})")
    return HARDWARE_REGISTRY[hw_type]
