"""The TransSMT virtual CPU (reference HARDWARE_TYPE 2) — stack-based,
multi-memory-space hardware for host–parasite coevolution.

Reference: cHardwareTransSMT (avida-core/source/cpu/cHardwareTransSMT.{cc,h}).
Architecture per organism (h:45-92):
  4 stacks (3 thread-local AX/BX/CX + 1 global DX, 10-deep), 4 nops
  (Nop-A..D selecting stacks/heads 0-3), 4 heads per thread carrying
  (memory_space, position), multiple memory spaces (space 0 = the genome;
  labels hash to auxiliary spaces, FindMemorySpaceLabel cc:376), one thread
  per active memory space, Inst_Inject (cc:1657) = parasite transmission
  into a neighbor's memory space, inherited/config virulence (cc:218-248)
  = probability a CPU cycle goes to the parasite thread.

Lockstep model (ops/interpreter_smt.py): 2 threads (host, parasite) x 2
memory spaces each (base space + ONE auxiliary write buffer) -- the stock
ancestors (support/config/default-transsmt*.org) use exactly one labeled
space; arbitrary label->space maps degenerate to the single aux space
(documented simplification).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_STACKS = 4         # 3 local + 1 global (h:45-47)
NUM_NOPS = 4
STACK_AX, STACK_BX, STACK_CX, STACK_DX = range(4)
HEAD_IP, HEAD_READ, HEAD_WRITE, HEAD_FLOW = range(4)
MAX_LABEL_SIZE = 3     # MAX_MEMSPACE_LABEL/label reads use short templates

# semantic opcodes (interpreter_smt dispatch)
(
    SEM_NOP,
    SEM_SHIFT_R, SEM_SHIFT_L, SEM_NAND, SEM_ADD, SEM_SUB, SEM_MULT,
    SEM_DIV, SEM_MOD, SEM_INC, SEM_DEC,
    SEM_SET_MEMORY, SEM_DIVIDE, SEM_READ, SEM_WRITE,
    SEM_IF_EQU, SEM_IF_NEQU, SEM_IF_LESS, SEM_IF_GTR,
    SEM_HEAD_PUSH, SEM_HEAD_POP, SEM_HEAD_MOVE, SEM_SEARCH,
    SEM_PUSH_NEXT, SEM_PUSH_PREV, SEM_PUSH_COMP,
    SEM_VAL_DELETE, SEM_VAL_COPY, SEM_IO, SEM_INJECT,
) = range(30)


@dataclass(frozen=True)
class SmtSpec:
    name: str
    sem: int
    doc: str = ""


_S = SmtSpec
INSTRUCTIONS = {
    "Nop-A": _S("Nop-A", SEM_NOP), "Nop-B": _S("Nop-B", SEM_NOP),
    "Nop-C": _S("Nop-C", SEM_NOP), "Nop-D": _S("Nop-D", SEM_NOP),
    "Nop-X": _S("Nop-X", SEM_NOP, "true no-op (not a modifier)"),
    "Val-Shift-R": _S("Val-Shift-R", SEM_SHIFT_R, "?BX? <- top>>1 (pop+push)"),
    "Val-Shift-L": _S("Val-Shift-L", SEM_SHIFT_L),
    "Val-Nand": _S("Val-Nand", SEM_NAND, "push ~(op1.top & op2.top) (cc:919)"),
    "Val-Add": _S("Val-Add", SEM_ADD), "Val-Sub": _S("Val-Sub", SEM_SUB),
    "Val-Mult": _S("Val-Mult", SEM_MULT), "Val-Div": _S("Val-Div", SEM_DIV),
    "Val-Mod": _S("Val-Mod", SEM_MOD),
    "Val-Inc": _S("Val-Inc", SEM_INC, "pop, push value+1 (cc:1010)"),
    "Val-Dec": _S("Val-Dec", SEM_DEC),
    "SetMemory": _S("SetMemory", SEM_SET_MEMORY,
                    "FLOW <- (aux space, 0) (cc:1567)"),
    "Divide": _S("Divide", SEM_DIVIDE,
                 "divide off the write-head's space (Divide_Main cc:438)"),
    "Divide-Erase": _S("Divide-Erase", SEM_DIVIDE),
    "Inst-Read": _S("Inst-Read", SEM_READ,
                    "push inst at ?READ? (copy-mut) + advance (cc:1304)"),
    "Inst-Write": _S("Inst-Write", SEM_WRITE,
                     "write popped inst at ?WRITE?, grow space (cc:1341)"),
    "If-Equal": _S("If-Equal", SEM_IF_EQU,
                   "skip next unless ?AX?.top == next.top (cc:1075)"),
    "If-Not-Equal": _S("If-Not-Equal", SEM_IF_NEQU),
    "If-Less": _S("If-Less", SEM_IF_LESS),
    "If-Greater": _S("If-Greater", SEM_IF_GTR),
    "Head-Push": _S("Head-Push", SEM_HEAD_PUSH, "push pos(?IP?) (cc:1133)"),
    "Head-Pop": _S("Head-Pop", SEM_HEAD_POP),
    "Head-Move": _S("Head-Move", SEM_HEAD_MOVE,
                    "?IP? <- FLOW; FLOW alone advances (cc:1151)"),
    "Search": _S("Search", SEM_SEARCH,
                 "complement-label search; BX dist, AX size, FLOW there "
                 "(cc:1172)"),
    "Push-Next": _S("Push-Next", SEM_PUSH_NEXT,
                    "dst=?src+1?: push src.pop (cc:1197)"),
    "Push-Prev": _S("Push-Prev", SEM_PUSH_PREV),
    "Push-Comp": _S("Push-Comp", SEM_PUSH_COMP),
    "Val-Delete": _S("Val-Delete", SEM_VAL_DELETE),
    "Val-Copy": _S("Val-Copy", SEM_VAL_COPY),
    "IO": _S("IO", SEM_IO, "output ?BX?.top, input push (cc:1231)"),
    "Inject": _S("Inject", SEM_INJECT,
                 "inject write-space code into faced neighbor (cc:1657)"),
}

ALIASES = {
    "nop-A": "Nop-A", "nop-B": "Nop-B", "nop-C": "Nop-C", "nop-D": "Nop-D",
}


def build_semantic_tables(inst_names):
    """opcode -> semantic tables for the SMT interpreter.  Same contract as
    models/heads.build_semantic_tables (mod_kind/default_op are unused by
    the SMT interpreter; operand resolution is per-semantic)."""
    n = len(inst_names)
    sem = np.zeros(n, np.int32)
    is_nop = np.zeros(n, bool)
    nop_mod = np.zeros(n, np.int32)
    for op, name in enumerate(inst_names):
        key = ALIASES.get(name, name)
        if key not in INSTRUCTIONS:
            raise ValueError(
                f"transsmt hardware does not implement instruction {name!r}")
        spec = INSTRUCTIONS[key]
        sem[op] = spec.sem
        # modifier nops are exactly Nop-A..D (Nop-X is a pure no-op)
        if key in ("Nop-A", "Nop-B", "Nop-C", "Nop-D"):
            is_nop[op] = True
            nop_mod[op] = ("Nop-A", "Nop-B", "Nop-C", "Nop-D").index(key)
    return {
        "sem": sem, "mod_kind": np.zeros(n, np.int32),
        "default_op": np.zeros(n, np.int32),
        "is_nop": is_nop, "nop_mod": nop_mod, "num_insts": n,
    }
