"""Population state: structure-of-arrays tensors for the whole world.

The counterpart of avida_tpu/core/state.py.  `PopulationState` keeps the
reference's field names, dtypes and shapes (one slot per grid cell, the
`alive` mask defining occupancy), so `convert.py` maps a reference state
onto this one field by field.  `WorldParams` holds the static parameters
as plain Python scalars and tuples.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from avida_tpu_torch.utils import faultinject, prng


@dataclass(frozen=True)
class WorldParams:
    """Static run parameters (the reference's WorldParams, same fields)."""
    hw_type: int = 0
    num_registers: int = 3
    num_nops: int = 3
    parasite_virulence: float = -1.0
    world_x: int = 60
    world_y: int = 60
    geometry: int = 2
    max_memory: int = 384
    min_genome_len: int = 8
    num_insts: int = 26
    sem: tuple = ()
    mod_kind: tuple = ()
    default_op: tuple = ()
    is_nop: tuple = ()
    nop_mod: tuple = ()
    mut_cdf: tuple = ()
    inst_cost: tuple = ()
    inst_ft_cost: tuple = ()
    inst_prob_fail: tuple = ()
    inst_addl_time_cost: tuple = ()
    copy_mut_prob: float = 0.0075
    copy_ins_prob: float = 0.0
    copy_del_prob: float = 0.0
    divide_mut_prob: float = 0.0
    divide_ins_prob: float = 0.05
    divide_del_prob: float = 0.05
    div_mut_prob: float = 0.0
    divide_slip_prob: float = 0.0
    point_mut_prob: float = 0.0
    offspring_size_range: float = 2.0
    recombination_prob: float = 1.0
    min_copied_lines: float = 0.5
    min_exe_lines: float = 0.5
    require_allocate: bool = True
    ave_time_slice: int = 30
    slicing_method: int = 1
    base_merit_method: int = 4
    base_const_merit: int = 100
    default_bonus: float = 1.0
    inherit_merit: bool = True
    max_steps_per_update: int = 0
    use_pallas: int = 0
    lane_perm_k: int = 0
    lane_perm_min_util: float = 0.5
    kernel_shards: int = 0
    packed_chunk: int = 1
    packed_fused: int = 1
    packed_bits: int = 0
    energy_enabled: bool = False
    energy_given_on_inject: float = 0.0
    energy_given_at_birth: float = 0.0
    frac_parent_energy: float = 0.5
    frac_energy_decay_birth: float = 0.0
    energy_cap: float = -1.0
    num_cycles_exc: int = 200
    fix_metabolic_rate: float = -1.0
    inst_energy_cost: tuple = ()
    dispersal_rate: float = 1.0
    nb_cap: int = 0
    trace_cap: int = 0
    trace_stall_util: float = 0.25
    fault_nan: tuple = ()
    fault_bitflip: tuple = ()
    max_cpu_threads: int = 1
    thread_slicing_method: int = 0
    death_method: int = 2
    age_limit: int = 20
    num_demes: int = 1
    demes_use_germline: int = 0
    germline_copy_mut: float = 0.0075
    demes_max_age: int = 500
    demes_max_births: int = 100
    demes_migration_rate: float = 0.0
    demes_migration_method: int = 0
    mating_types: bool = False
    lekking: bool = False
    module_num: int = 0
    pred_prey_switch: int = -1
    pred_efficiency: float = 1.0
    demes_num_x: int = 0
    migration_cdf: tuple = ()
    birth_method: int = 0
    population_cap: int = 0
    pop_cap_eldest: int = 0
    prefer_empty: bool = True
    allow_parent: bool = True
    divide_method: int = 1
    generation_inc_method: int = 1
    num_reactions: int = 9
    task_logic_mask: tuple = ()
    proc_value: tuple = ()
    proc_type: tuple = ()
    max_task_count: tuple = ()
    min_task_count: tuple = ()
    req_reaction_mask: tuple = ()
    noreq_reaction_mask: tuple = ()
    task_math_name: tuple = ()
    proc_res_idx: tuple = ()
    proc_res_spatial: tuple = ()
    proc_max: tuple = ()
    proc_frac: tuple = ()
    proc_depletable: tuple = ()
    proc_product_idx: tuple = ()
    proc_product_spatial: tuple = ()
    proc_conversion: tuple = ()
    num_deme_res: int = 0
    dres_inflow: tuple = ()
    dres_outflow: tuple = ()
    dres_initial: tuple = ()
    proc_res_deme: tuple = ()
    num_global_res: int = 0
    res_inflow: tuple = ()
    res_outflow: tuple = ()
    res_initial: tuple = ()
    num_spatial_res: int = 0
    sres_inflow: tuple = ()
    sres_outflow: tuple = ()
    sres_initial: tuple = ()
    sres_xdiffuse: tuple = ()
    sres_ydiffuse: tuple = ()
    sres_inflow_box: tuple = ()
    sres_torus: tuple = ()
    sres_grad_height: tuple = ()
    sres_grad_spread: tuple = ()
    sres_grad_plateau: tuple = ()
    sres_grad_updatestep: tuple = ()
    sres_grad_move: tuple = ()
    sres_grad_peakx: tuple = ()
    sres_grad_peaky: tuple = ()

    @property
    def num_cells(self) -> int:
        return self.world_x * self.world_y

    def replace(self, **kw) -> "WorldParams":
        return dataclasses.replace(self, **kw)


def _migration_cdf(cfg):
    """Method-4 migration: each source deme's cumulative weight row from
    the MIGRATION_FILE matrix (cMigrationMatrix::GetProbabilisticDemeID),
    accumulated in float64 as the reference does."""
    if int(cfg.DEMES_MIGRATION_METHOD) != 4:
        return ()
    mat = getattr(cfg, "_migration_matrix", None)
    if mat is None:
        raise ValueError(
            "DEMES_MIGRATION_METHOD 4 requires MIGRATION_FILE (an NxN "
            "weight matrix; cMigrationMatrix::Load)")
    rows = []
    for r in mat:
        tot = float(sum(r))
        if tot <= 0:
            raise ValueError("MIGRATION_FILE row with no positive weight")
        acc, row = 0.0, []
        for v in r:
            acc += float(v) / tot
            row.append(acc)
        rows.append(tuple(row))
    return tuple(rows)


def make_world_params(cfg, instset, environment) -> WorldParams:
    """Build WorldParams from parsed config objects (host side).  The
    reference's validation is kept, and the device fault kinds of
    TPU_FAULT (utils/faultinject.py) ride fault_nan / fault_bitflip.  A
    MIGRATION_FILE matrix (demes,
    method 4) is read by World and attached to cfg as
    `_migration_matrix`."""
    tables = instset_tables(instset)
    env_tables = environment.device_tables()

    def tt(a):
        return tuple(map(tuple, a)) if a.ndim == 2 else tuple(a.tolist())

    if getattr(instset, "res_cost", None) is not None \
            and np.asarray(instset.res_cost).any():
        raise NotImplementedError(
            "instset res_cost (resource-bin execution costs, cInstSet.h:69) "
            "is not implemented; zero the res_cost column")
    for r in environment.spatial_resources():
        if r.is_gradient and (r.peakx >= cfg.WORLD_X
                              or r.peaky >= cfg.WORLD_Y):
            raise ValueError(
                f"GRADIENT_RESOURCE {r.name!r} peak ({r.peakx},{r.peaky}) "
                f"lies outside the {cfg.WORLD_X}x{cfg.WORLD_Y} world")
    if cfg.MAX_CPU_THREADS > 1 and instset.hw_type != 0:
        raise NotImplementedError(
            "MAX_CPU_THREADS > 1 is implemented for heads hardware only "
            "(TransSMT has its own host/parasite thread model)")
    if instset.hw_type in (1, 2) and (instset.cost.any()
                                      or instset.ft_cost.any()
                                      or instset.prob_fail.any()
                                      or instset.addl_time_cost.any()):
        raise NotImplementedError(
            "instruction costs/prob_fail/addl_time_cost are not implemented "
            "for TransSMT hardware yet; zero those columns or use heads "
            "hardware")
    if int(cfg.DEMES_MIGRATION_METHOD) == 3:
        raise NotImplementedError(
            "DEMES_MIGRATION_METHOD 3 (deme points) needs the deme points "
            "system, which is not modeled; use methods 0/1/2/4")
    if int(cfg.DEMES_MIGRATION_METHOD) == 1 and cfg.NUM_DEMES > 1 \
            and (cfg.DEMES_NUM_X <= 0
                 or cfg.NUM_DEMES % max(cfg.DEMES_NUM_X, 1)):
        raise ValueError(
            "DEMES_MIGRATION_METHOD 1 requires DEMES_NUM_X dividing "
            "NUM_DEMES (cPopulation.cc:5530)")
    if cfg.POPULATION_CAP and cfg.POP_CAP_ELDEST:
        raise ValueError(
            "POPULATION_CAP and POP_CAP_ELDEST are mutually exclusive "
            "carrying-capacity policies (cPopulation.cc:5192-5238)")
    sres = environment.spatial_resources()
    gres = environment.global_resources()
    dres = environment.deme_resources()
    return WorldParams(
        hw_type=instset.hw_type,
        num_registers=8 if instset.hw_type == 3 else 3,
        num_nops=int(sum(bool(x) for x in tables["is_nop"])) or 3,
        parasite_virulence=cfg.PARASITE_VIRULENCE,
        world_x=cfg.WORLD_X, world_y=cfg.WORLD_Y, geometry=cfg.WORLD_GEOMETRY,
        max_memory=cfg.TPU_MAX_MEMORY,
        min_genome_len=8,
        num_insts=tables["num_insts"],
        sem=tuple(tables["sem"].tolist()),
        mod_kind=tuple(tables["mod_kind"].tolist()),
        default_op=tuple(tables["default_op"].tolist()),
        is_nop=tuple(tables["is_nop"].tolist()),
        nop_mod=tuple(tables["nop_mod"].tolist()),
        mut_cdf=tuple(np.cumsum(instset.mutation_weights()).tolist()),
        inst_cost=(tuple(instset.cost.tolist())
                   if instset.cost.any() else ()),
        inst_ft_cost=(tuple(instset.ft_cost.tolist())
                      if instset.ft_cost.any() else ()),
        inst_prob_fail=(tuple(float(x) for x in instset.prob_fail)
                        if instset.prob_fail.any() else ()),
        inst_addl_time_cost=(tuple(int(x) for x in instset.addl_time_cost)
                             if instset.addl_time_cost.any() else ()),
        copy_mut_prob=cfg.COPY_MUT_PROB,
        copy_ins_prob=cfg.COPY_INS_PROB,
        copy_del_prob=cfg.COPY_DEL_PROB,
        divide_mut_prob=cfg.DIVIDE_MUT_PROB,
        divide_ins_prob=cfg.DIVIDE_INS_PROB,
        divide_del_prob=cfg.DIVIDE_DEL_PROB,
        div_mut_prob=cfg.DIV_MUT_PROB,
        divide_slip_prob=cfg.DIVIDE_SLIP_PROB,
        point_mut_prob=cfg.POINT_MUT_PROB,
        offspring_size_range=cfg.OFFSPRING_SIZE_RANGE,
        recombination_prob=cfg.RECOMBINATION_PROB,
        min_copied_lines=cfg.MIN_COPIED_LINES,
        min_exe_lines=cfg.MIN_EXE_LINES,
        require_allocate=bool(cfg.REQUIRE_ALLOCATE),
        ave_time_slice=cfg.AVE_TIME_SLICE,
        slicing_method=cfg.SLICING_METHOD,
        base_merit_method=cfg.BASE_MERIT_METHOD,
        base_const_merit=cfg.BASE_CONST_MERIT,
        default_bonus=cfg.DEFAULT_BONUS,
        inherit_merit=bool(cfg.INHERIT_MERIT),
        max_steps_per_update=cfg.TPU_MAX_STEPS_PER_UPDATE,
        use_pallas=cfg.TPU_USE_PALLAS,
        lane_perm_k=int(cfg.get("TPU_LANE_PERM", 1)),
        lane_perm_min_util=float(cfg.get("TPU_LANE_PERM_MIN_UTIL", 0.5)),
        kernel_shards=int(cfg.get("TPU_KERNEL_SHARDS", 0)),
        packed_chunk=int(cfg.get("TPU_PACKED_CHUNK", 1)),
        packed_fused=int(cfg.get("TPU_PACKED_FUSED", 1)),
        packed_bits=int(cfg.get("TPU_PACKED_BITS", 0)),
        num_demes=cfg.NUM_DEMES,
        demes_use_germline=cfg.DEMES_USE_GERMLINE,
        germline_copy_mut=cfg.GERMLINE_COPY_MUT,
        demes_max_age=cfg.DEMES_MAX_AGE,
        demes_max_births=cfg.DEMES_MAX_BIRTHS,
        demes_migration_rate=cfg.DEMES_MIGRATION_RATE,
        demes_migration_method=int(cfg.DEMES_MIGRATION_METHOD),
        mating_types=bool(cfg.MATING_TYPES),
        lekking=bool(cfg.LEKKING),
        module_num=int(cfg.MODULE_NUM),
        pred_prey_switch=int(cfg.PRED_PREY_SWITCH),
        pred_efficiency=float(cfg.PRED_EFFICIENCY),
        demes_num_x=int(cfg.DEMES_NUM_X),
        migration_cdf=_migration_cdf(cfg),
        death_method=cfg.DEATH_METHOD,
        age_limit=cfg.AGE_LIMIT,
        birth_method=cfg.BIRTH_METHOD,
        population_cap=cfg.POPULATION_CAP,
        pop_cap_eldest=cfg.POP_CAP_ELDEST,
        prefer_empty=bool(cfg.PREFER_EMPTY),
        allow_parent=bool(cfg.ALLOW_PARENT),
        divide_method=cfg.DIVIDE_METHOD,
        energy_enabled=bool(cfg.ENERGY_ENABLED),
        energy_given_on_inject=cfg.ENERGY_GIVEN_ON_INJECT,
        energy_given_at_birth=cfg.ENERGY_GIVEN_AT_BIRTH,
        frac_parent_energy=cfg.FRAC_PARENT_ENERGY_GIVEN_TO_ORG_AT_BIRTH,
        frac_energy_decay_birth=cfg.FRAC_ENERGY_DECAY_AT_ORG_BIRTH,
        energy_cap=cfg.ENERGY_CAP,
        num_cycles_exc=cfg.NUM_CYCLES_EXC_BEFORE_0_ENERGY,
        fix_metabolic_rate=cfg.FIX_METABOLIC_RATE,
        inst_energy_cost=tuple(float(x) for x in instset.energy_cost)
        if instset.energy_cost.any() else (),
        dispersal_rate=cfg.DISPERSAL_RATE,
        max_cpu_threads=max(int(cfg.MAX_CPU_THREADS), 1),
        thread_slicing_method=int(cfg.THREAD_SLICING_METHOD),
        nb_cap=2 * cfg.WORLD_X * cfg.WORLD_Y
        if cfg.get("TPU_SYSTEMATICS", 1) else 0,
        trace_cap=int(cfg.get("TPU_TRACE_CAP", 4096))
        if int(cfg.get("TPU_TRACE", 0)) else 0,
        trace_stall_util=float(cfg.get("TPU_TRACE_STALL_UTIL", 0.25)),
        fault_nan=faultinject.nan_param(cfg),
        fault_bitflip=faultinject.bitflip_param(cfg),
        generation_inc_method=cfg.GENERATION_INC_METHOD,
        num_reactions=len(environment.reactions),
        task_logic_mask=tt(env_tables["task_logic_mask"]),
        proc_value=tuple(env_tables["proc_value"].tolist()),
        proc_type=tuple(env_tables["proc_type"].tolist()),
        max_task_count=tuple(env_tables["max_task_count"].tolist()),
        min_task_count=tuple(env_tables["min_task_count"].tolist()),
        req_reaction_mask=tt(env_tables["req_reaction_mask"]),
        noreq_reaction_mask=tt(env_tables["noreq_reaction_mask"]),
        task_math_name=env_tables["task_math_name"],
        proc_res_idx=tuple(env_tables["proc_res_idx"].tolist()),
        proc_res_spatial=tuple(env_tables["proc_res_spatial"].tolist()),
        proc_max=tuple(env_tables["proc_max"].tolist()),
        proc_frac=tuple(env_tables["proc_frac"].tolist()),
        proc_depletable=tuple(env_tables["proc_depletable"].tolist()),
        proc_product_idx=tuple(env_tables["proc_product_idx"].tolist()),
        proc_product_spatial=tuple(
            env_tables["proc_product_spatial"].tolist()),
        proc_conversion=tuple(env_tables["proc_conversion"].tolist()),
        num_deme_res=len(dres),
        dres_inflow=tuple(r.inflow for r in dres),
        dres_outflow=tuple(r.outflow for r in dres),
        dres_initial=tuple(r.initial for r in dres),
        proc_res_deme=tuple(env_tables["proc_res_deme"].tolist()),
        num_global_res=len(gres),
        res_inflow=tuple(r.inflow for r in gres),
        res_outflow=tuple(r.outflow for r in gres),
        res_initial=tuple(r.initial for r in gres),
        num_spatial_res=len(sres),
        sres_inflow=tuple(r.inflow for r in sres),
        sres_outflow=tuple(r.outflow for r in sres),
        sres_initial=tuple(r.initial for r in sres),
        sres_xdiffuse=tuple(r.xdiffuse for r in sres),
        sres_ydiffuse=tuple(r.ydiffuse for r in sres),
        sres_inflow_box=tuple((r.inflowx1, r.inflowx2, r.inflowy1, r.inflowy2)
                              for r in sres),
        sres_torus=tuple(r.geometry == "torus" for r in sres),
        sres_grad_height=tuple(r.height for r in sres),
        sres_grad_spread=tuple(r.spread for r in sres),
        sres_grad_plateau=tuple(r.plateau for r in sres),
        sres_grad_updatestep=tuple(r.updatestep for r in sres),
        sres_grad_move=tuple(r.move_a_scaler > 1 for r in sres),
        sres_grad_peakx=tuple(r.peakx for r in sres),
        sres_grad_peaky=tuple(r.peaky for r in sres),
    )


def instset_tables(instset):
    """Semantic tables of an instruction set, from its hardware's module
    (models/registry.py)."""
    from avida_tpu_torch.models.registry import get_hardware
    mod = get_hardware(instset.hw_type)["module"]
    if len(instset.inst_names) > 64:
        raise ValueError(
            "packed-tape layout supports <= 64 instructions per set "
            "(6 opcode bits + 2 flag bits)")
    return mod.build_semantic_tables(instset.inst_names)


# (name, dtype, shape) for every PopulationState leaf, in the reference's
# field order.  Shapes use n cells, L tape length, R reactions, Te extra
# thread slots, NR registers, T/Ls the TransSMT axes, Rg/Rs/Rd resource
# counts, D demes, CAP the newborn ring, TCAP the trace ring (None = off).
_I32, _U8, _I8, _F32, _B = (torch.int32, torch.uint8, torch.int8,
                            torch.float32, torch.bool)
_FIELDS = (
    ("tape", _U8, "n L"), ("mem_len", _I32, "n"), ("regs", _I32, "n NR"),
    ("heads", _I32, "n 4"), ("stacks", _I32, "n 2 10"), ("sp", _I32, "n 2"),
    ("active_stack", _I32, "n"), ("read_label", _I8, "n 10"),
    ("read_label_len", _I32, "n"), ("t_alive", _B, "n Te"),
    ("main_tid", _I32, "n"), ("t_ids", _I32, "n Te"),
    ("cur_thread", _I32, "n"), ("t_regs", _I32, "n Te NR"),
    ("t_heads", _I32, "n Te 4"), ("t_stack", _I32, "n Te 10"),
    ("t_sp", _I32, "n Te"), ("t_active_stack", _I32, "n Te"),
    ("t_rlabel", _I8, "n Te 10"), ("t_rlabel_len", _I32, "n Te"),
    ("mal_active", _B, "n"), ("alive", _B, "n"), ("genome", _I8, "n L"),
    ("genome_len", _I32, "n"), ("inputs", _I32, "n 3"),
    ("input_ptr", _I32, "n"), ("input_buf", _I32, "n 3"),
    ("input_buf_n", _I32, "n"), ("output_buf", _I32, "n"),
    ("merit", _F32, "n"), ("cur_bonus", _F32, "n"),
    ("cur_task_count", _I32, "n R"), ("task_exe_total", _I32, "n R"),
    ("cur_reaction_count", _I32, "n R"), ("last_task_count", _I32, "n R"),
    ("time_used", _I32, "n"), ("cpu_cycles", _I32, "n"),
    ("gestation_start", _I32, "n"), ("gestation_time", _I32, "n"),
    ("fitness", _F32, "n"), ("last_bonus", _F32, "n"),
    ("last_merit_base", _F32, "n"), ("executed_size", _I32, "n"),
    ("copied_size", _I32, "n"), ("child_copied_size", _I32, "n"),
    ("generation", _I32, "n"), ("max_executed", _I32, "n"),
    ("num_divides", _I32, "n"), ("sterile", _B, "n"),
    ("breed_true", _B, "n"), ("divide_pending", _B, "n"),
    ("off_start", _I32, "n"), ("off_len", _I32, "n"),
    ("off_tape", _U8, "n L"), ("off_copied_size", _I32, "n"),
    ("off_sex", _B, "n"), ("mating_type", _I32, "n"),
    ("bc_mem", _I8, "L"), ("bc_len", _I32, ""), ("bc_merit", _F32, ""),
    ("bc_valid", _B, ""), ("bc_type", _I32, ""),
    ("deme_birth_count", _I32, "D"), ("deme_age", _I32, "D"),
    ("germ_mem", _I8, "D L"), ("germ_len", _I32, "D"),
    ("energy", _F32, "n"), ("energy_spent", _F32, "n"),
    ("deme_resources", _F32, "D Rd"), ("nb_genome", _I8, "CAP L"),
    ("nb_len", _I32, "CAP"), ("nb_cell", _I32, "CAP"),
    ("nb_parent", _I32, "CAP"), ("nb_update", _I32, "CAP"),
    ("nb_count", _I32, ""), ("tr_update", _I32, "TCAP"),
    ("tr_cell", _I32, "TCAP"), ("tr_code", _I32, "TCAP"),
    ("tr_payload", _I32, "TCAP"), ("tr_count", _I32, "TRC"),
    ("facing", _I32, "n"), ("forage_target", _I32, "n"),
    ("smt_aux", _U8, "n T Ls"), ("smt_aux_len", _I32, "n T"),
    ("pmem", _U8, "n Ls"), ("pmem_len", _I32, "n"),
    ("parasite_active", _B, "n"), ("smt_stacks", _I32, "n T 3 10"),
    ("smt_sp", _I32, "n T 3"), ("gstack", _I32, "n G"), ("gsp", _I32, "n"),
    ("smt_head_pos", _I32, "n T 4"), ("smt_head_space", _I32, "n T 4"),
    ("inject_pending", _B, "n"), ("inj_mem", _U8, "n Ls"),
    ("inj_len", _I32, "n"), ("genotype_id", _I32, "n"),
    ("parent_id", _I32, "n"), ("birth_update", _I32, "n"),
    ("cost_wait", _I32, "n"), ("ft_paid_lo", _I32, "n"),
    ("ft_paid_hi", _I32, "n"), ("insts_executed", _I32, "n"),
    ("budget_carry", _I32, "n"), ("lane_perm", _I32, "n"),
    ("lane_inv", _I32, "n"), ("resources", _F32, "Rg"),
    ("res_grid", _F32, "Rs n"), ("grad_peak", _I32, "Rs 2"),
)
FIELD_DTYPES = {name: dt for name, dt, _ in _FIELDS}
# the per-organism fields (leading axis: one slot per cell)
LANE_FIELDS = tuple(name for name, _, shape in _FIELDS
                    if shape.split()[:1] == ["n"])
# fields whose fresh value is not zero
_FILL = {"forage_target": -1, "mating_type": -1, "bc_type": -1,
         "genotype_id": -1, "parent_id": -1, "birth_update": -1,
         "grad_peak": -1}


@dataclass(frozen=True)
class PopulationState:
    """All per-organism (= per-cell) device state; see the reference's
    PopulationState for each field's meaning.  Leaves are torch tensors
    (the trace-ring leaves are None while the recorder is off)."""
    tape: torch.Tensor
    mem_len: torch.Tensor
    regs: torch.Tensor
    heads: torch.Tensor
    stacks: torch.Tensor
    sp: torch.Tensor
    active_stack: torch.Tensor
    read_label: torch.Tensor
    read_label_len: torch.Tensor
    t_alive: torch.Tensor
    main_tid: torch.Tensor
    t_ids: torch.Tensor
    cur_thread: torch.Tensor
    t_regs: torch.Tensor
    t_heads: torch.Tensor
    t_stack: torch.Tensor
    t_sp: torch.Tensor
    t_active_stack: torch.Tensor
    t_rlabel: torch.Tensor
    t_rlabel_len: torch.Tensor
    mal_active: torch.Tensor
    alive: torch.Tensor
    genome: torch.Tensor
    genome_len: torch.Tensor
    inputs: torch.Tensor
    input_ptr: torch.Tensor
    input_buf: torch.Tensor
    input_buf_n: torch.Tensor
    output_buf: torch.Tensor
    merit: torch.Tensor
    cur_bonus: torch.Tensor
    cur_task_count: torch.Tensor
    task_exe_total: torch.Tensor
    cur_reaction_count: torch.Tensor
    last_task_count: torch.Tensor
    time_used: torch.Tensor
    cpu_cycles: torch.Tensor
    gestation_start: torch.Tensor
    gestation_time: torch.Tensor
    fitness: torch.Tensor
    last_bonus: torch.Tensor
    last_merit_base: torch.Tensor
    executed_size: torch.Tensor
    copied_size: torch.Tensor
    child_copied_size: torch.Tensor
    generation: torch.Tensor
    max_executed: torch.Tensor
    num_divides: torch.Tensor
    sterile: torch.Tensor
    breed_true: torch.Tensor
    divide_pending: torch.Tensor
    off_start: torch.Tensor
    off_len: torch.Tensor
    off_tape: torch.Tensor
    off_copied_size: torch.Tensor
    off_sex: torch.Tensor
    mating_type: torch.Tensor
    bc_mem: torch.Tensor
    bc_len: torch.Tensor
    bc_merit: torch.Tensor
    bc_valid: torch.Tensor
    bc_type: torch.Tensor
    deme_birth_count: torch.Tensor
    deme_age: torch.Tensor
    germ_mem: torch.Tensor
    germ_len: torch.Tensor
    energy: torch.Tensor
    energy_spent: torch.Tensor
    deme_resources: torch.Tensor
    nb_genome: torch.Tensor
    nb_len: torch.Tensor
    nb_cell: torch.Tensor
    nb_parent: torch.Tensor
    nb_update: torch.Tensor
    nb_count: torch.Tensor
    tr_update: torch.Tensor | None
    tr_cell: torch.Tensor | None
    tr_code: torch.Tensor | None
    tr_payload: torch.Tensor | None
    tr_count: torch.Tensor | None
    facing: torch.Tensor
    forage_target: torch.Tensor
    smt_aux: torch.Tensor
    smt_aux_len: torch.Tensor
    pmem: torch.Tensor
    pmem_len: torch.Tensor
    parasite_active: torch.Tensor
    smt_stacks: torch.Tensor
    smt_sp: torch.Tensor
    gstack: torch.Tensor
    gsp: torch.Tensor
    smt_head_pos: torch.Tensor
    smt_head_space: torch.Tensor
    inject_pending: torch.Tensor
    inj_mem: torch.Tensor
    inj_len: torch.Tensor
    genotype_id: torch.Tensor
    parent_id: torch.Tensor
    birth_update: torch.Tensor
    cost_wait: torch.Tensor
    ft_paid_lo: torch.Tensor
    ft_paid_hi: torch.Tensor
    insts_executed: torch.Tensor
    budget_carry: torch.Tensor
    lane_perm: torch.Tensor
    lane_inv: torch.Tensor
    resources: torch.Tensor
    res_grid: torch.Tensor
    grad_peak: torch.Tensor

    def replace(self, **kw) -> "PopulationState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.alive.device


def zeros_population(n: int, L: int, R: int, n_global_res: int = 0,
                     n_spatial_res: int = 0, n_demes: int = 1,
                     smt: bool = False, num_registers: int = 3,
                     nb_cap: int = 0, n_deme_res: int = 0,
                     max_threads: int = 1, trace_cap: int = 0,
                     device="cpu") -> PopulationState:
    """A fresh (all-empty) population of n cells.  `smt` gives the
    TransSMT axes their sizes (two threads, memory spaces of L sites, a
    10-deep global stack); on heads hardware they are empty."""
    dims = {"n": n, "L": L, "R": R, "Te": max(max_threads, 1) - 1,
            "NR": num_registers, "T": 2 if smt else 0, "Ls": L if smt else 0,
            "G": 10 if smt else 0,
            "Rg": n_global_res, "Rs": n_spatial_res, "D": n_demes,
            "Rd": n_deme_res, "CAP": nb_cap, "TCAP": trace_cap}
    leaves = {}
    for name, dt, shape in _FIELDS:
        if name.startswith("tr_") and not trace_cap:
            leaves[name] = None
            continue
        shp = tuple(dims[s] if s in dims else int(s)
                    for s in shape.split() if s != "TRC")
        leaves[name] = torch.full(shp, _FILL.get(name, 0), dtype=dt,
                                  device=device)
    leaves["lane_perm"] = torch.arange(n, dtype=_I32, device=device)
    leaves["lane_inv"] = torch.arange(n, dtype=_I32, device=device)
    return PopulationState(**leaves)


def make_cell_inputs(key: torch.Tensor, n: int) -> torch.Tensor:
    """Patterned random inputs: top 8 bits 0x0F/0x33/0x55, low 24 random
    (ref cEnvironment::SetupInputs, cEnvironment.cc:1268-1276)."""
    low = prng.randint(key, (n, 3), 0, 1 << 24)
    tops = torch.tensor([15 << 24, 51 << 24, 85 << 24], dtype=_I32,
                        device=key.device)
    return tops[None, :] + low


TRACE_RING_FIELDS = ("tr_update", "tr_cell", "tr_code", "tr_payload",
                     "tr_count")
WORLD_LEVEL_FIELDS = frozenset({
    "resources", "res_grid", "grad_peak",
    "bc_mem", "bc_len", "bc_merit", "bc_valid",
    "deme_birth_count", "deme_age", "germ_mem", "germ_len", "deme_resources",
    "lane_perm", "lane_inv",
    "nb_genome", "nb_len", "nb_cell", "nb_parent", "nb_update", "nb_count",
    *TRACE_RING_FIELDS,
})


def state_field_names() -> tuple:
    """Canonical ordered leaf names of PopulationState (the reference's
    order, so states convert field by field)."""
    return tuple(f.name for f in dataclasses.fields(PopulationState))


# ---- batched states: W worlds stacked on a leading axis of every leaf ----

def stack_states(states) -> PopulationState:
    """W same-shaped states -> one batched state (a new leading world axis
    on every leaf; disabled leaves stay None)."""
    first = states[0]
    return PopulationState(**{
        name: (None if getattr(first, name) is None
               else torch.stack([getattr(s, name) for s in states]))
        for name in state_field_names()})


def world_state(bst: PopulationState, w: int) -> PopulationState:
    """World w of a batched state, as views of its leaves."""
    return PopulationState(**{
        name: (None if getattr(bst, name) is None else getattr(bst, name)[w])
        for name in state_field_names()})


def unstack_states(bst: PopulationState) -> list:
    """A batched state -> its W worlds (views)."""
    return [world_state(bst, w) for w in range(bst.alive.shape[0])]


def is_smt(params) -> bool:
    """Does `params` run the TransSMT hardware (HARDWARE_TYPE 1 or 2)?"""
    return params.hw_type in (1, 2)


def smt_base_spaces(device) -> torch.Tensor:
    """int32[2, 4]: the memory space of every head of a fresh TransSMT
    CPU, the host thread's in its genome (space 0), the parasite
    thread's in its code (space 2)."""
    return torch.tensor([[0] * 4, [2] * 4], dtype=_I32, device=device)


def _max_executed(params, glen):
    if params.death_method == 2:
        return params.age_limit * glen
    return params.age_limit if params.death_method == 1 else 2**30


def seed_organism(params: WorldParams, st: PopulationState,
                  seed_genome: np.ndarray, key: torch.Tensor,
                  cell: int) -> PopulationState:
    """Write ONE fresh organism into `cell` (ref cPopulation::Inject
    cc:7377 + cPhenotype::SetupInject cc:599): every per-organism field at
    the cell resets to its fresh default, then the genome and its
    phenotype land."""
    n, L, R = params.num_cells, params.max_memory, params.num_reactions
    blank = zeros_population(1, L, R, params.num_global_res,
                             params.num_spatial_res, 1,
                             smt=is_smt(params),
                             num_registers=params.num_registers,
                             max_threads=params.max_cpu_threads,
                             device=st.device)
    c = cell
    updates = {}
    for name in state_field_names():
        if name in WORLD_LEVEL_FIELDS:
            continue
        v = getattr(st, name)
        if v is None or v.ndim == 0 or v.shape[0] != n:
            continue
        v = v.clone()
        v[c] = getattr(blank, name)[0]
        updates[name] = v
    st = st.replace(**updates)

    glen = len(seed_genome)
    if glen > L:
        raise ValueError(f"seed genome length {glen} exceeds max_memory {L}")
    g = np.zeros(L, np.int8)
    g[:glen] = seed_genome
    g_t = torch.from_numpy(g).to(st.device)
    k_in = prng.split(key)[0]

    def put(field, value):
        v = getattr(st, field).clone()
        v[c] = value
        return v

    return st.replace(
        tape=put("tape", g_t.to(torch.uint8)),
        genome=put("genome", g_t),
        mem_len=put("mem_len", glen),
        genome_len=put("genome_len", glen),
        alive=put("alive", True),
        merit=put("merit", float(glen)),
        energy=put("energy", params.energy_given_on_inject),
        cur_bonus=put("cur_bonus", params.default_bonus),
        executed_size=put("executed_size", glen),
        copied_size=put("copied_size", glen),
        max_executed=put("max_executed", _max_executed(params, glen)),
        inputs=put("inputs", make_cell_inputs(k_in, 1)[0]),
    )


def init_population(params: WorldParams, seed_genome: np.ndarray,
                    key: torch.Tensor, inject_cell: int | None = None
                    ) -> PopulationState:
    """World with a single injected ancestor (ref ActivateOrganism +
    cPhenotype::SetupInject, cPhenotype.cc:599)."""
    n, L, R = params.num_cells, params.max_memory, params.num_reactions
    dev = key.device
    st = zeros_population(n, L, R, params.num_global_res,
                          params.num_spatial_res, params.num_demes,
                          smt=is_smt(params),
                          num_registers=params.num_registers,
                          nb_cap=params.nb_cap,
                          n_deme_res=params.num_deme_res,
                          max_threads=params.max_cpu_threads,
                          trace_cap=params.trace_cap, device=dev)
    ks = prng.split(key)
    k_inputs, key = ks[0], ks[1]
    st = st.replace(
        inputs=make_cell_inputs(k_inputs, n),
        deme_resources=torch.tensor(
            params.dres_initial, dtype=_F32, device=dev)[None, :].expand(
                params.num_demes, params.num_deme_res).clone(),
        resources=torch.tensor(params.res_initial, dtype=_F32, device=dev),
        res_grid=torch.tensor(
            params.sres_initial, dtype=_F32, device=dev)[:, None].expand(
                params.num_spatial_res, n).clone())
    if inject_cell is None:
        inject_cell = n // 2
    st = seed_organism(params, st, seed_genome, key, inject_cell)
    if params.demes_use_germline:
        # every deme's germline starts as the ancestor (cGermline seeded
        # at world setup)
        g = np.zeros(L, np.int8)
        g[:len(seed_genome)] = seed_genome
        st = st.replace(
            germ_mem=torch.from_numpy(g).to(dev)[None, :].expand(
                params.num_demes, L).clone(),
            germ_len=torch.full((params.num_demes,), len(seed_genome),
                                dtype=torch.int32, device=dev))
    if is_smt(params):
        st = st.replace(smt_head_space=smt_base_spaces(dev)[None].expand(
            n, 2, 4).clone())
    return st


def clone_state(st: PopulationState) -> PopulationState:
    """An owned copy of every leaf (a retained pre-chunk state)."""
    return PopulationState(**{
        name: (None if getattr(st, name) is None
               else getattr(st, name).clone())
        for name in state_field_names()})
