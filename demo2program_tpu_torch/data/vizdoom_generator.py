"""ViZDoom dataset generator.

Port of demo2program_tpu/data/vizdoom_generator.py (`vizdoom_env/
generator.py`, + `generator_ifelse.py` via the `ifelse` flag): spins up
num_demo + num_test_demo persistent game instances, samples percept-balanced
programs against the first group of worlds, verifies them on the held-out
worlds, and keeps 80x80 RGB demos, action ids, perception histories and
per-pos-key initial actor positions, in the HDF5 schema that
data/vizdoom_dataset.py reads.

The loop is the JAX package's, draw for draw, in `iter_items`; `generate`
writes its items to `data.hdf5` + `id.txt` and data/vizdoom_memory.py keeps
them in memory. Frames are shrunk by utils/area_resize.py, bit for bit as
cv2's INTER_AREA, so no cv2 is needed. h5py is imported where the file is
written.
"""

import os
from dataclasses import dataclass

import numpy as np

from demo2program_tpu_torch.dsl import vizdoom_interp, vizdoom_parser
from demo2program_tpu_torch.dsl.vizdoom_sampler import (
    DoomProgramGenerator, DoomProgramGeneratorIfElse)
from demo2program_tpu_torch.dsl.vizdoom_vocab import VizDoomDSLVocab
from demo2program_tpu_torch.utils import log
from demo2program_tpu_torch.utils.area_resize import area_resize

POS_KEYS = ["player_pos", "demon_pos", "hellknight_pos",
            "revenant_pos", "ammo_pos"]


class DoomStateGenerator:
    """Random initial actor placement (`vizdoom_env/generator.py:20-83`)."""

    def __init__(self, seed=None):
        self.rng = np.random.RandomState(seed)
        self.x_max, self.x_min = 64, -480
        self.y_max, self.y_min = 480, 64

    def gen_rand_pos(self):
        return [int(self.rng.randint(self.x_min, self.x_max)),
                int(self.rng.randint(self.y_min, self.y_max))]

    def get_pos_keys(self):
        return list(POS_KEYS)

    def generate_initial_state(self, min_ammo=4, max_ammo=5,
                               min_monster=4, max_monster=5):
        s = {"player_pos": self.gen_rand_pos(), "demon_pos": [],
             "hellknight_pos": [], "revenant_pos": [], "ammo_pos": []}
        locs = [s["player_pos"]]
        counts = {
            "revenant_pos": self.rng.randint(min_monster, max_monster + 1),
            "hellknight_pos": self.rng.randint(min_monster, max_monster + 1),
            "demon_pos": self.rng.randint(min_monster, max_monster + 1),
            "ammo_pos": self.rng.randint(min_ammo, max_ammo + 1),
        }
        for key in ["revenant_pos", "hellknight_pos", "demon_pos",
                    "ammo_pos"]:
            remaining = counts[key]
            while remaining > 0:
                pos = self.gen_rand_pos()
                if pos not in locs:
                    s[key].append(pos)
                    locs.append(pos)
                    remaining -= 1
        return s


def downsize(img, h=80, w=80):
    """cv2.resize(img, (h, w), interpolation=INTER_AREA), as the JAX
    generator calls it (cv2's dsize is (width, height))."""
    return area_resize(img, (h, w))


@dataclass
class VizdoomGeneratorConfig:
    dir_name: str = "datasets/vizdoom_dataset"
    engine_config: str = None  # None -> the packaged assets/doomlite.cfg
    num_train: int = 10000
    num_test: int = 1000
    num_val: int = 100
    seed: int = 123
    max_program_length: int = 32
    min_demo_length: int = 2
    max_demo_length: int = 8
    num_demo_per_program: int = 40
    num_test_demo_per_program: int = 10
    width: int = 80
    height: int = 80
    perception_type: str = "simple"
    sprite_style: str = "v2"  # DoomLite sprite rendering style
    ifelse: bool = False  # generator_ifelse.py variant


def iter_items(cfg, info):
    """Yield (id, group) for cfg.num_train + num_test + num_val programs,
    group holding the arrays of one HDF5 group; `info` (a dict) receives
    the data_info entries once the last item is out."""
    from demo2program_tpu_torch.envs.vizdoom import Vizdoom_env

    num_total = cfg.num_train + cfg.num_test + cfg.num_val
    num_demo = cfg.num_demo_per_program + cfg.num_test_demo_per_program

    log.info("Initializing %d vizdoom environments...", num_demo)
    world_list = []
    for _ in range(num_demo):
        world = Vizdoom_env(config=cfg.engine_config,
                            perception_type=cfg.perception_type,
                            sprite_style=cfg.sprite_style)
        world.init_game()
        world_list.append(world)
    h, w, c = cfg.height, cfg.width, world_list[0].channel

    gen = DoomStateGenerator(seed=cfg.seed)
    prog_cls = DoomProgramGeneratorIfElse if cfg.ifelse \
        else DoomProgramGenerator
    prog_gen = prog_cls(seed=cfg.seed)
    percepts = world_list[0].get_perception_vector_cond()
    vocab = VizDoomDSLVocab(perception_type=cfg.perception_type)

    pos_keys = gen.get_pos_keys()
    count = 0
    max_demo_len_seen = -1
    max_prog_len_seen = -1
    max_init_poslen = -1
    while count < num_total:
        init_states = []
        for world in world_list:
            init_states.append(gen.generate_initial_state())
            world.new_episode(init_states[-1])

        program, ok = prog_gen.random_code(
            percepts, world_list[:cfg.num_demo_per_program])
        if not ok or len(program.split()) > cfg.max_program_length:
            continue
        program_seq = np.array(vocab.str2intseq(program), dtype=np.int8)
        ast, ok = vizdoom_parser.parse(program)
        if not ok:
            raise RuntimeError("Program compile failure should not happen")

        # verify on held-out worlds
        all_ok = True
        for k, world in enumerate(world_list[cfg.num_demo_per_program:]):
            idx = k + cfg.num_demo_per_program
            world.new_episode(init_states[idx])
            _, success = vizdoom_interp.execute(ast, world)
            if not success or not (cfg.min_demo_length <= len(world.s_h)
                                   <= cfg.max_demo_length):
                all_ok = False
                break
        if not all_ok:
            continue
        if any(not (cfg.min_demo_length <= len(world.s_h)
                    <= cfg.max_demo_length) for world in world_list):
            continue

        s_h_list = [np.stack(world.s_h, axis=0) for world in world_list]
        a_h_list = [np.array(vocab.action_strlist2intseq(world.a_h))
                    for world in world_list]
        p_v_list = [np.stack(world.p_v_h, axis=0) for world in world_list]
        len_s_h = np.array([x.shape[0] for x in s_h_list], dtype=np.int16)
        len_a_h = np.array([x.shape[0] for x in a_h_list], dtype=np.int16)

        demos_s_h = np.zeros([num_demo, len_s_h.max(), h, w, c],
                             dtype=np.int16)
        for i, s_h in enumerate(s_h_list):
            frames = (downsize(s_h, h, w) if s_h.shape[1:3] != (h, w)
                      else s_h)  # the whole demo at once, frame by frame
            demos_s_h[i, :len(frames)] = frames
        demos_a_h = np.zeros([num_demo, len_a_h.max()], dtype=np.int8)
        for i, a_h in enumerate(a_h_list):
            demos_a_h[i, :a_h.shape[0]] = a_h
        demos_p_v = np.zeros([num_demo, len_s_h.max(), len(percepts)],
                             dtype=bool)
        for i, p_v in enumerate(p_v_list):
            demos_p_v[i, :p_v.shape[0]] = p_v

        # init positions: [num_demo, #pos_key, max(#pos), 2]
        key_maxlen = max(
            max(len(s[k]) if isinstance(s[k][0], list) else 1
                for s in init_states) if init_states else 1
            for k in pos_keys)
        init_np = np.zeros([num_demo, len(pos_keys), key_maxlen, 2],
                           dtype=np.int32)
        init_len = np.zeros([num_demo, len(pos_keys)], dtype=np.int32)
        for d, s in enumerate(init_states):
            for p, key in enumerate(pos_keys):
                arr = np.array(s[key], dtype=np.int32)
                if arr.ndim == 1:
                    arr = arr[None, :]
                init_np[d, p, :arr.shape[0]] = arr
                init_len[d, p] = arr.shape[0]
        max_init_poslen = max(max_init_poslen, key_maxlen)

        id_ = "no_{}_prog_len_{}_max_s_h_len_{}".format(
            count, program_seq.shape[0], int(len_s_h.max()))
        nd = cfg.num_demo_per_program
        yield id_, {
            "program": program_seq,
            "s_h_len": len_s_h[:nd],
            "s_h": demos_s_h[:nd],
            "a_h_len": len_a_h[:nd],
            "a_h": demos_a_h[:nd],
            "p_v_h": demos_p_v[:nd],
            "test_s_h_len": len_s_h[nd:],
            "test_s_h": demos_s_h[nd:],
            "test_a_h_len": len_a_h[nd:],
            "test_a_h": demos_a_h[nd:],
            "test_p_v_h": demos_p_v[nd:],
            "vizdoom_init_pos": init_np[:nd],
            "vizdoom_init_pos_len": init_len[:nd],
            "test_vizdoom_init_pos": init_np[nd:],
            "test_vizdoom_init_pos_len": init_len[nd:],
        }

        max_demo_len_seen = max(max_demo_len_seen, int(len_s_h.max()))
        max_prog_len_seen = max(max_prog_len_seen, program_seq.shape[0])
        count += 1
        if count % 100 == 0:
            log.info("generated %d / %d", count, num_total)

    info.update({
        "max_demo_length": max_demo_len_seen,
        "max_program_length": max_prog_len_seen,
        "num_program_tokens": len(vocab.int2token),
        "num_demo_per_program": cfg.num_demo_per_program,
        "num_test_demo_per_program": cfg.num_test_demo_per_program,
        "num_action_tokens": len(vocab.action_int2token),
        "num_train": cfg.num_train,
        "num_test": cfg.num_test,
        "num_val": cfg.num_val,
        "s_h_h": h,
        "s_h_w": w,
        "s_h_c": c,
        "percepts": percepts,
        "vizdoom_pos_keys": pos_keys,
        "vizdoom_max_init_pos_len": max_init_poslen,
        "perception_type": cfg.perception_type,
        "sprite_style": cfg.sprite_style,
    })
    for world in world_list:
        world.end_game()


def generate(cfg: VizdoomGeneratorConfig):
    """Write the dataset to cfg.dir_name: data.hdf5 and id.txt."""
    import h5py

    os.makedirs(cfg.dir_name, exist_ok=True)
    info = {}
    with h5py.File(os.path.join(cfg.dir_name, "data.hdf5"), "w") as f, \
            open(os.path.join(cfg.dir_name, "id.txt"), "w") as id_file:
        for id_, item in iter_items(cfg, info):
            id_file.write(id_ + "\n")
            grp = f.create_group(id_)
            for key, value in item.items():
                grp[key] = value
        grp = f.create_group("data_info")
        for key, value in info.items():
            grp[key] = value
    log.info("Dataset generated under %s with %d samples", cfg.dir_name,
             cfg.num_train + cfg.num_test + cfg.num_val)
