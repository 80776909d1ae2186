"""In-memory Karel split in the compact wire format, made from a seed.

Follows the python backend of demo2program_tpu/data/karel_generator.py
(program sampling, unique programs, demos rolled from batches of sampled
initial states and kept when their length lies in [min_demo_len,
max_demo_len]) but keeps only what `get_batch_compact`
(data/dataset.py:283-312) serves: token ids, initial states and recorded
actions. No HDF5 file and no h5py are involved, so a split can be made on
any host and handed to the Evaler like a dataset split.
"""

from dataclasses import dataclass

import numpy as np

from demo2program_tpu_torch.dsl import karel_interp, karel_parser
from demo2program_tpu_torch.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.envs.karel import KarelStateGenerator, KarelWorld
from demo2program_tpu_torch.envs.karel import batch_to_states

# the generator's fixed settings (data/karel_generator.py:GeneratorConfig)
_H = _W = 8
_WALL_PROB = 0.1
_MAX_STMT_DEPTH, _MAX_NESTING_DEPTH = 6, 4
_MAX_DEMO_TRIALS, _MAX_TEST_DEMO_TRIALS = 100, 10000
_TRIAL_CHUNK = 64  # states sampled per generate_batch call


@dataclass(frozen=True)
class SplitConfig:
    num_programs: int = 96
    seed: int = 123
    k: int = 10
    test_k: int = 5
    max_program_len: int = 45
    max_demo_len: int = 20
    min_demo_len: int = 8


def _roll_demos(ast, sgen, cfg, num_needed, max_trials):
    """-> list of (wall, marker0, agent0, actions, state-history length)
    for demos of `ast` whose length lies in [min_demo_len, max_demo_len]."""
    demos = []
    trials = 0
    while len(demos) < num_needed and trials < max_trials:
        chunk = min(_TRIAL_CHUNK, max_trials - trials)
        trials += chunk
        walls, markers0, agent0 = sgen.generate_batch(
            chunk, _H, _W, _WALL_PROB)
        for i, s0 in enumerate(batch_to_states(walls, markers0, agent0)):
            if len(demos) >= num_needed:
                break
            world = KarelWorld(s0, make_error=True)
            _, success = karel_interp.execute(ast, world)
            if not success:
                continue
            if not cfg.min_demo_len <= len(world.s_h) <= cfg.max_demo_len:
                continue
            demos.append((walls[i], markers0[i], agent0[i],
                          np.asarray(world.a_h, np.int8), len(world.s_h)))
    return demos


def _compact(demos, T):
    """One item's seen (or unseen) demos -> its compact arrays, as
    data/dataset.py:_CompactStore stores them."""
    a_raw = np.zeros((len(demos), T), np.int8)
    for i, d in enumerate(demos):
        a_raw[i, :len(d[3])] = d[3]
    return {
        "c_wall": np.stack([d[0] for d in demos]).astype(np.uint8),
        "c_marker": np.stack([d[1] for d in demos]).astype(np.uint8),
        "c_agent": np.stack([d[2] for d in demos]).astype(np.uint8),
        "c_a_raw": a_raw,
        # a stored item's a_h matrix is as wide as its longest demo's
        # action row (karel_generator._pad_stack)
        "c_a_row_len": np.array([max(len(d[3]) for d in demos)], np.int32),
        "demo_len": np.array([d[4] for d in demos], np.float32),
    }


class InMemoryKarelSplit:
    """A Karel split held as compact arrays: `ids`, `get_batch_compact`."""

    dsl_type = "prob"
    env_type = None

    def __init__(self, arrays, ids):
        self.arr = arrays
        self.ids = list(ids)
        self.index = {id_: i for i, id_ in enumerate(self.ids)}

    def get_batch_compact(self, id_list):
        idx = np.fromiter((self.index[i] for i in id_list), np.int64,
                          count=len(id_list))
        batch = {key: v[idx] for key, v in self.arr.items()}
        batch["id"] = np.asarray(id_list)
        return batch


def generate_split(cfg=SplitConfig()):
    """Sample cfg.num_programs unique programs with k seen and test_k unseen
    demos each -> InMemoryKarelSplit."""
    vocab = KarelVocab()
    sampler = KarelProgramSampler(seed=cfg.seed)
    sgen = KarelStateGenerator(seed=cfg.seed)
    seen_programs = set()
    cols = {}
    ids = []
    while len(ids) < cfg.num_programs:
        code = sampler.random_code(max_depth=_MAX_STMT_DEPTH,
                                   max_nesting_depth=_MAX_NESTING_DEPTH)
        if code in seen_programs:
            continue
        tokens = vocab.str2intseq(code)
        if len(tokens) > cfg.max_program_len:
            continue
        ast, ok = karel_parser.parse(code)
        if not ok:
            raise ValueError(f"sampled program does not parse: {code}")
        seen = _roll_demos(ast, sgen, cfg, cfg.k, _MAX_DEMO_TRIALS)
        if len(seen) < cfg.k:
            continue
        test = _roll_demos(ast, sgen, cfg, cfg.test_k, _MAX_TEST_DEMO_TRIALS)
        if len(test) < cfg.test_k:
            continue
        seen_programs.add(code)
        program = np.zeros(cfg.max_program_len, np.int32)
        program[:len(tokens)] = tokens
        item = {"program_tokens": program,
                "program_len": np.array([len(tokens)], np.float32)}
        for pfx, demos in (("", seen), ("test_", test)):
            item.update({pfx + key: v for key, v in
                         _compact(demos, cfg.max_demo_len).items()})
        for key, v in item.items():
            cols.setdefault(key, []).append(v)
        ids.append("no_{}_prog_len_{}_max_s_h_len_{}".format(
            len(ids), len(tokens), int(max(d[4] for d in seen))))
    return InMemoryKarelSplit({k: np.stack(v) for k, v in cols.items()},
                              ids)
