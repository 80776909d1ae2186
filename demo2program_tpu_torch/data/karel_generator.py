"""Karel dataset generator: the reference's HDF5 schema in one pass.

Port of demo2program_tpu/data/karel_generator.py (`karel_env/generator.py`
-> `append_demonstration.py` -> `add_per.py` in one pass). Each item is one
group of data.hdf5:

  <id>/program        int8   [prog_len]          token ids
  <id>/s_h            bool   [N, Tmax_prog, h, w, 16]
  <id>/s_h_len        int16  [N]
  <id>/a_h            int8   [N, Tmax_prog-1]
  <id>/a_h_len        int16  [N]
  <id>/per            bool   [N, Tmax_prog, 5]   perception vectors
  <id>/test_*         the same, for the unseen test demos
  data_info/{max_demo_length, dsl_type, max_program_length,
             num_program_tokens, num_demo_per_program, num_action_tokens,
             num_train, num_test, num_val, num_test_demo_per_program}

ids read 'no_{i}_prog_len_{L}_max_s_h_len_{T}', and the order of id.txt
defines the train/test/val split (data/dataset.py:all_ids).

Generation is split from writing: `generate_records(cfg, backend)` yields
every item as (id, arrays) and then ("data_info", info) and never touches
h5py, so a host without h5py can generate in memory; `generate` writes the
records to data.hdf5 + id.txt with h5py imported inside it.

Backends: 'python' (the host interpreter) and 'native' (csrc/
karel_engine.cpp, native.py) draw the same random stream (states are
sampled in chunks of 64 whichever executes them), and 'auto' takes native
when it builds. As in the JAX generator, the native backend skips a
program whose bytecode is too long before it draws any state, where the
python backend rolls its demos; the two agree whenever no sampled program
is that long.
"""

import os
from dataclasses import dataclass

import numpy as np

from demo2program_tpu_torch.dsl import karel_interp, karel_parser
from demo2program_tpu_torch.dsl.karel_bytecode import (
    BytecodeTooLong, compile_ast)
from demo2program_tpu_torch.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.envs.karel import (
    KarelStateGenerator, KarelWorld, batch_to_states)
from demo2program_tpu_torch.utils import log


@dataclass
class GeneratorConfig:
    dir_name: str = "datasets/karel_dataset"
    height: int = 8
    width: int = 8
    num_train: int = 25000
    num_test: int = 5000
    num_val: int = 5000
    wall_prob: float = 0.1
    seed: int = 123
    max_program_length: int = 50
    max_program_stmt_depth: int = 6
    max_program_nesting_depth: int = 4
    min_max_demo_length_for_program: int = 2
    min_demo_length: int = 8
    max_demo_length: int = 20
    num_demo_per_program: int = 10
    num_test_demo_per_program: int = 5
    max_demo_generation_trial: int = 100
    max_test_demo_generation_trial: int = 10000


_TRIAL_CHUNK = 64

# facing deltas of the perception checks (envs/karel.py)
_DELTAS = {
    "front": np.array([[-1, 0], [0, 1], [1, 0], [0, -1]]),
    "left": np.array([[0, -1], [-1, 0], [0, 1], [1, 0]]),
    "right": np.array([[0, 1], [1, 0], [0, -1], [-1, 0]]),
}


def _clear(wall, y, x, d, which, h, w):
    dy, dx = _DELTAS[which][d]
    ny, nx = y + dy, x + dx
    if ny < 0 or ny >= h or nx < 0 or nx >= w:
        return False
    return not wall[ny, nx]


def _trace_to_arrays(wall, agent, markers, length, h, w):
    """Native-engine trace -> (s_h (L,h,w,16) bool, per (L,5) bool)."""
    L = int(length)
    s = np.zeros((L, h, w, 16), bool)
    s[:, :, :, 4] = wall
    s[:, :, :, 5:] = np.eye(11, dtype=bool)[markers[:L]]
    per = np.zeros((L, 5), bool)
    for t in range(L):
        y, x, d = agent[t]
        s[t, y, x, d] = True
        mk = markers[t, y, x] > 0
        per[t] = [_clear(wall, y, x, d, "front", h, w),
                  _clear(wall, y, x, d, "left", h, w),
                  _clear(wall, y, x, d, "right", h, w),
                  mk, not mk]
    return s, per


def _roll_demos(ast, sgen, cfg, num_needed, max_trials, bytecode=None,
                use_native=False):
    """Sample initial states and execute `ast`, keeping demos whose state
    history length lies in [min_demo_length, max_demo_length].

    States are sampled in fixed chunks so the accepted-demo set is identical
    for the python and native backends (both consume the same rng stream)."""
    s_h_list, a_h_list, per_list = [], [], []
    trials = 0
    h, w = cfg.height, cfg.width
    while len(s_h_list) < num_needed and trials < max_trials:
        chunk = min(_TRIAL_CHUNK, max_trials - trials)
        trials += chunk
        walls, markers0, agent0 = sgen.generate_batch(
            chunk, h, w, cfg.wall_prob)
        if use_native:
            from demo2program_tpu_torch import native
            out = native.run_batch(
                bytecode[None], walls, markers0, agent0,
                np.zeros(chunk, np.int32), make_error=True,
                max_record=cfg.max_demo_length)
            for i in range(chunk):
                if len(s_h_list) >= num_needed:
                    break
                if not out["success"][i]:
                    continue
                L = int(out["length"][i])
                if not (cfg.min_demo_length <= L <= cfg.max_demo_length):
                    continue
                s_h, per = _trace_to_arrays(
                    walls[i], out["agent"][i], out["markers"][i], L, h, w)
                s_h_list.append(s_h)
                a_h_list.append(out["actions"][i, :L - 1].copy())
                per_list.append(per)
        else:
            for s0 in batch_to_states(walls, markers0, agent0):
                if len(s_h_list) >= num_needed:
                    break
                world = KarelWorld(s0, make_error=True)
                _, success = karel_interp.execute(ast, world)
                if not success:
                    continue
                if not (cfg.min_demo_length <= len(world.s_h)
                        <= cfg.max_demo_length):
                    continue
                s_h_list.append(np.stack(world.s_h, axis=0))
                a_h_list.append(np.array(world.a_h, dtype=np.int8))
                per_list.append(np.stack(world.p_v_h, axis=0))
    return s_h_list, a_h_list, per_list


def _pad_stack(arrs, dtype):
    """Stack variable-length [T, ...] arrays padded to the max T."""
    n = len(arrs)
    tmax = max(a.shape[0] for a in arrs)
    out = np.zeros((n, tmax) + arrs[0].shape[1:], dtype=dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out


def resolve_backend(backend):
    """'auto' | 'native' | 'python' -> use the native engine? 'auto' takes
    it when it builds and logs which backend it took; 'native' builds it
    now, so a failed build raises before any program is drawn."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}")
    from demo2program_tpu_torch import native
    if backend == "auto":
        use_native = native.available()
        log.info("karel generator: backend auto -> %s",
                 "native" if use_native else "python")
        return use_native
    if backend == "native":
        native.build()
        return True
    return False


def generate_records(cfg: GeneratorConfig, backend="auto",
                     progress_every=500):
    """Yield (id, {name: array}) for each accepted program in id order,
    then ("data_info", {name: scalar or str}). Both backends yield the same
    records for a seed (see the module docstring)."""
    num_total = cfg.num_train + cfg.num_test + cfg.num_val
    use_native = resolve_backend(backend)
    if use_native:
        log.info("karel generator: using the native C++ engine")

    vocab = KarelVocab()
    sampler = KarelProgramSampler(seed=cfg.seed)
    sgen = KarelStateGenerator(seed=cfg.seed)

    count = 0
    max_demo_len_seen = -1
    max_prog_len_seen = -1
    seen_programs = set()
    while count < num_total:
        code = sampler.random_code(
            max_depth=cfg.max_program_stmt_depth,
            max_nesting_depth=cfg.max_program_nesting_depth)
        if code in seen_programs:
            continue
        program_seq = np.array(vocab.str2intseq(code), dtype=np.int8)
        if program_seq.shape[0] > cfg.max_program_length:
            continue
        ast, ok = karel_parser.parse(code)
        assert ok, code
        bytecode = None
        if use_native:
            try:
                bytecode = compile_ast(ast)
            except BytecodeTooLong:
                continue  # cannot roll demos for it either way

        s_h_list, a_h_list, per_list = _roll_demos(
            ast, sgen, cfg, cfg.num_demo_per_program,
            cfg.max_demo_generation_trial, bytecode, use_native)
        if len(s_h_list) < cfg.num_demo_per_program:
            continue
        len_s_h = np.array([s.shape[0] for s in s_h_list], dtype=np.int16)
        if len_s_h.max() < cfg.min_max_demo_length_for_program:
            continue

        # unseen test demos: no accept-rate gate, only a safety cap
        t_s_h, t_a_h, t_per = _roll_demos(
            ast, sgen, cfg, cfg.num_test_demo_per_program,
            cfg.max_test_demo_generation_trial, bytecode, use_native)
        if len(t_s_h) < cfg.num_test_demo_per_program:
            continue
        len_t_s_h = np.array([s.shape[0] for s in t_s_h], dtype=np.int16)

        seen_programs.add(code)
        id_ = "no_{}_prog_len_{}_max_s_h_len_{}".format(
            count, program_seq.shape[0], int(len_s_h.max()))
        yield id_, {
            "program": program_seq,
            "s_h_len": len_s_h,
            "a_h_len": np.array([a.shape[0] for a in a_h_list],
                                dtype=np.int16),
            "s_h": _pad_stack(s_h_list, bool),
            "a_h": _pad_stack(a_h_list, np.int8),
            "per": _pad_stack(per_list, bool),
            "test_s_h_len": len_t_s_h,
            "test_a_h_len": np.array([a.shape[0] for a in t_a_h],
                                     dtype=np.int16),
            "test_s_h": _pad_stack(t_s_h, bool),
            "test_a_h": _pad_stack(t_a_h, np.int8),
            "test_per": _pad_stack(t_per, bool),
        }

        max_demo_len_seen = max(max_demo_len_seen,
                                int(len_s_h.max()), int(len_t_s_h.max()))
        max_prog_len_seen = max(max_prog_len_seen, program_seq.shape[0])
        count += 1
        if progress_every and count % progress_every == 0:
            log.info("generated %d / %d programs", count, num_total)

    # python ints and a str, as the JAX generator hands them to h5py
    yield "data_info", {
        "max_demo_length": max_demo_len_seen,
        "dsl_type": "prob",
        "max_program_length": max_prog_len_seen,
        "num_program_tokens": len(vocab.int2token),
        "num_demo_per_program": cfg.num_demo_per_program,
        "num_test_demo_per_program": cfg.num_test_demo_per_program,
        "num_action_tokens": vocab.num_action_tokens,
        "num_train": cfg.num_train,
        "num_test": cfg.num_test,
        "num_val": cfg.num_val,
    }


def generate(cfg: GeneratorConfig, progress_every=500, backend="auto"):
    """Write generate_records' records to cfg.dir_name: data.hdf5 (one group
    a record, data_info last) and id.txt."""
    import h5py

    os.makedirs(cfg.dir_name, exist_ok=True)
    num_total = cfg.num_train + cfg.num_test + cfg.num_val
    with h5py.File(os.path.join(cfg.dir_name, "data.hdf5"), "w") as f, \
            open(os.path.join(cfg.dir_name, "id.txt"), "w") as id_file:
        for id_, arrays in generate_records(cfg, backend, progress_every):
            if id_ != "data_info":
                id_file.write(id_ + "\n")
            grp = f.create_group(id_)
            for key, value in arrays.items():
                grp[key] = value
    log.info("dataset generated under %s with %d samples (%d train / %d "
             "test / %d val)", cfg.dir_name, num_total, cfg.num_train,
             cfg.num_test, cfg.num_val)
