"""The experimental virtual CPU (reference cHardwareExperimental).

Semantic instruction table for the research CPU with rich sensing
(ref: cHardwareExperimental.{cc,h} -- 8 registers at h:66, 8 nops,
sensor/movement/predation families fed by cOrgSensor; instset files
declare hw_type=3, e.g. support/config/instset-experimental.cfg and
tests/avatars-pred_look/config/instset.cfg).

Round-4 scope (the VERDICT r3 directive's done-bar): the 8-register base
plus the sensing/movement family -- every instruction in the
instset-experimental.cfg replication set and the avatars-pred_look
predator/prey set.  The remaining ~200 instructions (group behaviour,
messaging displays, resource collection variants) raise loudly at load.

Shared semantics (heads, stacks, copy loop, divide) reuse the heads
semantic opcodes; execution happens in ops/interpreter.micro_step, which
is parameterized on register/nop counts and implements the new opcodes
behind static hw_type gates.
"""

from __future__ import annotations

import numpy as np

from avida_tpu_torch.models.heads import (InstSpec, MOD_HEAD, MOD_LABEL, MOD_NONE,
                                    MOD_REG, HEAD_IP, SEM_ADD, SEM_DEC,
                                    SEM_GET_HEAD, SEM_H_ALLOC, SEM_H_COPY,
                                    SEM_H_DIVIDE, SEM_H_SEARCH, SEM_IF_LABEL,
                                    SEM_IF_LESS, SEM_IF_N_EQU, SEM_INC, SEM_IO,
                                    SEM_JMP_HEAD, SEM_MOV_HEAD, SEM_NAND,
                                    SEM_POP, SEM_PUSH, SEM_SET_FLOW,
                                    SEM_SHIFT_L, SEM_SHIFT_R, SEM_SUB,
                                    SEM_SWAP, SEM_SWAP_STK,
                                    NUM_SEMANTIC_OPS as _HEADS_OPS)

NUM_REGISTERS = 8        # rAX..rHX (cHardwareExperimental.h:66)
NUM_NOPS = 8             # nop-A..nop-H

# nop semantic ids: 0..7 (the first 8 semantic slots are nops for this
# hardware; the interpreter only needs is_nop/nop_mod tables, so nop sem
# ids merely have to be distinct)
SEM_NOP_BASE = 100       # sentinel range for nops D..H (never dispatched)

# new semantic opcodes (continue after the heads range)
(
    SEM_ZERO,            # zero ?BX? (Inst_ZeroReg)
    SEM_IF_NOT_0,        # exec next iff ?BX? != 0 (Inst_IfNotZero)
    SEM_IF_EQU_0,        # exec next iff ?BX? == 0 (Inst_IfEqualZero)
    SEM_MOVE,            # step into the faced cell (Inst_Move cc:3138)
    SEM_ROTATE_X,        # rotate facing by ?BX? steps (Inst_RotateX cc:3441)
    SEM_ROTATE_ORG_ID,   # face the neighbor with org id ?BX? (cc:3489)
    SEM_LOOK_AHEAD,      # ray-scan the faced direction (GoLook cc:3895)
    SEM_SET_FORAGE,      # forage target <- ?BX? (Inst_SetForageTarget)
    SEM_LABEL,           # consume a label, no other effect (Inst_Label)
    SEM_ATTACK_PREY,     # kill the faced prey, absorb merit/bonus
    #                      (Inst_AttackPrey cc:5407, ExecuteAttack cc:7001)
) = range(_HEADS_OPS, _HEADS_OPS + 10)

_R = list(range(NUM_REGISTERS))

INSTRUCTIONS = {
    # flow control (heads semantics, 8-register operand space)
    "if-n-equ": InstSpec("if-n-equ", SEM_IF_N_EQU, MOD_REG, 1),
    "if-less": InstSpec("if-less", SEM_IF_LESS, MOD_REG, 1),
    "if-label": InstSpec("if-label", SEM_IF_LABEL, MOD_LABEL, 0),
    "if-not-0": InstSpec("if-not-0", SEM_IF_NOT_0, MOD_REG, 1),
    "if-equ-0": InstSpec("if-equ-0", SEM_IF_EQU_0, MOD_REG, 1),
    "mov-head": InstSpec("mov-head", SEM_MOV_HEAD, MOD_HEAD, HEAD_IP),
    "jmp-head": InstSpec("jmp-head", SEM_JMP_HEAD, MOD_HEAD, HEAD_IP),
    "get-head": InstSpec("get-head", SEM_GET_HEAD, MOD_HEAD, HEAD_IP),
    "label": InstSpec("label", SEM_LABEL, MOD_LABEL, 0,
                      "consumes a label, no other effect (Inst_Label)"),
    "set-flow": InstSpec("set-flow", SEM_SET_FLOW, MOD_REG, 2),
    # math / stack
    "shift-r": InstSpec("shift-r", SEM_SHIFT_R, MOD_REG, 1),
    "shift-l": InstSpec("shift-l", SEM_SHIFT_L, MOD_REG, 1),
    "inc": InstSpec("inc", SEM_INC, MOD_REG, 1),
    "dec": InstSpec("dec", SEM_DEC, MOD_REG, 1),
    "zero": InstSpec("zero", SEM_ZERO, MOD_REG, 1),
    "push": InstSpec("push", SEM_PUSH, MOD_REG, 1),
    "pop": InstSpec("pop", SEM_POP, MOD_REG, 1),
    "swap-stk": InstSpec("swap-stk", SEM_SWAP_STK, MOD_NONE, 0),
    "swap": InstSpec("swap", SEM_SWAP, MOD_REG, 1),
    "add": InstSpec("add", SEM_ADD, MOD_REG, 1),
    "sub": InstSpec("sub", SEM_SUB, MOD_REG, 1),
    "nand": InstSpec("nand", SEM_NAND, MOD_REG, 1),
    # biology
    "h-copy": InstSpec("h-copy", SEM_H_COPY, MOD_NONE, 0),
    "h-alloc": InstSpec("h-alloc", SEM_H_ALLOC, MOD_NONE, 0),
    "h-divide": InstSpec("h-divide", SEM_H_DIVIDE, MOD_NONE, 0),
    "IO": InstSpec("IO", SEM_IO, MOD_REG, 1),
    "h-search": InstSpec("h-search", SEM_H_SEARCH, MOD_LABEL, 0),
    # sensing / movement (the cOrgSensor-fed family)
    "move": InstSpec("move", SEM_MOVE, MOD_REG, 1),
    "rotate-x": InstSpec("rotate-x", SEM_ROTATE_X, MOD_REG, 1),
    "rotate-org-id": InstSpec("rotate-org-id", SEM_ROTATE_ORG_ID, MOD_REG, 1),
    "look-ahead": InstSpec("look-ahead", SEM_LOOK_AHEAD, MOD_REG, 1),
    "set-forage-target": InstSpec("set-forage-target", SEM_SET_FORAGE,
                                  MOD_REG, 1),
    "attack-prey": InstSpec(
        "attack-prey", SEM_ATTACK_PREY, MOD_REG, 1,
        "kill the faced prey (forage target > -2): attacker merit/bonus "
        "+= PRED_EFFICIENCY x prey's, attacker becomes a predator "
        "(forage target -2), success echoed to ?BX? "
        "(Inst_AttackPrey cc:5407; PRED_PREY_SWITCH >= 0 required)"),
}

_NOP_NAMES = ["nop-A", "nop-B", "nop-C", "nop-D", "nop-E", "nop-F",
              "nop-G", "nop-H"]


def build_semantic_tables(inst_names):
    """Same contract as models.heads.build_semantic_tables, with 8 nops
    mapping to registers/heads 0..7."""
    n = len(inst_names)
    sem = np.zeros(n, np.int32)
    mod_kind = np.zeros(n, np.int32)
    default_op = np.zeros(n, np.int32)
    is_nop = np.zeros(n, bool)
    nop_mod = np.zeros(n, np.int32)
    for op, name in enumerate(inst_names):
        if name in _NOP_NAMES:
            is_nop[op] = True
            nop_mod[op] = _NOP_NAMES.index(name)
            sem[op] = SEM_NOP_BASE + nop_mod[op]
            continue
        if name not in INSTRUCTIONS:
            raise ValueError(
                f"experimental hardware does not implement instruction "
                f"{name!r} yet (round-4 scope: replication base + "
                f"sensing/movement; see models/experimental.py)")
        spec = INSTRUCTIONS[name]
        sem[op] = spec.sem
        mod_kind[op] = spec.mod_kind
        default_op[op] = spec.default_operand
    return {
        "sem": sem, "mod_kind": mod_kind, "default_op": default_op,
        "is_nop": is_nop, "nop_mod": nop_mod, "num_insts": n,
    }
