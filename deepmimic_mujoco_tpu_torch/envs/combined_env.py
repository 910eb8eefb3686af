"""Multi-motion combined env (DPCombinedEnv), batch-major torch.

The port of the JAX package's ``envs/combined_env.py``: the reference's
walk/run/getup/to-getup state machine with player commands (reference:
src/combined_env.py:102-533). The per-env "current mocap object" is an
integer ``motion_id`` indexing stacked, length-padded clip tensors, and
every transition is a masked selection per field on the device, so a
step holds no host branch on data and no host sync.

Motion ids: WALK=0, RUN=1, GETUP=2, TO_GETUP=3. TO_GETUP is the
reference's MTToGetup pseudo-clip: a constant target pose (getup clip
frame 1) with nominal length 180 (src/combined_env.py:95-99).

Reference quirk preserved: the getup-timeout branch compares the player
action with ``== PAWalk()``, which is always False for the identity-
comparing reference classes, so a finished getup always transitions to
RUN (src/combined_env.py:402). ``getup_timeout_to_walk=True`` gives the
evidently intended behavior.

Random draws come from a ``torch.Generator`` the caller passes in, or
are forced (``ResetDraws``); with a data-parallel ``shard`` either is the
global batch's draw and the rank keeps its slice (see ``DPEnv``). The JAX package draws the handoff-RSI and
facedown-RSI coins from one key (k4 and a split of it); the port draws
independent samples.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.envs import obs as obs_lib
from deepmimic_mujoco_tpu_torch.envs import reward as reward_lib
from deepmimic_mujoco_tpu_torch.envs.config import (
    DPCombinedEnvConfig, MotionConfig, RobotConfig,
)
from deepmimic_mujoco_tpu_torch.envs.dp_env import (
    DONE_MAX_EP_LEN, DONE_OBS_OOB,
)
from deepmimic_mujoco_tpu_torch.envs.graphs import StepGraphs
from deepmimic_mujoco_tpu_torch.envs.spec import RobotSpec
from deepmimic_mujoco_tpu_torch.mocap import load_clip
from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.models.physics_model import EULER
from deepmimic_mujoco_tpu_torch.physics.step import Engine
from deepmimic_mujoco_tpu_torch.utils import tracing

WALK, RUN, GETUP, TO_GETUP = 0, 1, 2, 3
MOTION_NAMES = ("walk", "run", "getup", "to_getup")

# player action table (reference: PAWalk vx=1, PARun vx=3)
PA_WALK, PA_RUN = 0, 1
_PA_HEADINGS = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)

DONE_FALLEN_NO_AMNESTY = 10
TO_GETUP_LEN = 180  # MTToGetup length (src/combined_env.py:99)


class HandoffBuffer(NamedTuple):
    """Ring buffer of physical states captured at GETUP -> locomotion
    transitions, shared by the env batch (it lives in the trainer's
    state, not in the env state). Resets draw from it with probability
    ``cfg.HANDOFF_BUFFER_FRAC``, so the handoff is practiced from the
    state distribution the current policy reaches."""
    qpos: torch.Tensor    # (C, nq)
    qvel: torch.Tensor    # (C, nv)
    pa: torch.Tensor      # (C,) int64 player action at the transition
    motion: torch.Tensor  # (C,) int64 motion entered (WALK or RUN)
    head: torch.Tensor    # () int64 next write slot
    count: torch.Tensor   # () int64 valid rows (<= C)


class CombinedEnvState(NamedTuple):
    qpos: torch.Tensor            # (B, nq)
    qvel: torch.Tensor            # (B, nv)
    motion_id: torch.Tensor       # (B,) int64 in {WALK, RUN, GETUP, TO_GETUP}
    n_steps: torch.Tensor         # (B,) int64 steps in the current motion
    player_action: torch.Tensor   # (B,) int64 in {PA_WALK, PA_RUN}
    episode_length: torch.Tensor  # (B,) int64
    episode_reward: torch.Tensor  # (B,) float32
    lam: torch.Tensor             # (B, n_warm_rows) warm-start forces


class CombinedStepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    done_reason: torch.Tensor
    imitation_reward: torch.Tensor
    task_reward: torch.Tensor
    reward_info: reward_lib.RewardInfo
    motion_id: torch.Tensor
    # active contacts dropped by the fixed-slot top-K selection this
    # step (0 = lossless); not in the JAX package's CombinedStepOut
    contact_overflow: torch.Tensor


class ResetDraws(NamedTuple):
    """The random draws of one batch of resets, each (B,): the
    walk/getup coin, the walk and getup frames, the handoff-RSI coin and
    its offset from the getup clip's end, the facedown coin, the
    run-command coin, the buffer coin and the buffer row. Forced draws
    (the parity tests) replace the generator's."""
    pick_walk: torch.Tensor
    walk_r: torch.Tensor
    getup_r: torch.Tensor
    pick_handoff: torch.Tensor
    handoff_r: torch.Tensor
    pick_fd: torch.Tensor
    pick_run: torch.Tensor
    use_buf: torch.Tensor
    buf_i: torch.Tensor


class DPCombinedEnv:
    version = "v0.2.up"

    def __init__(self, cfg: Optional[DPCombinedEnvConfig] = None,
                 getup_timeout_to_walk: bool = False,
                 max_contacts: int = 24,
                 iterations: Optional[int] = None,
                 integrator: Optional[int] = None,
                 warm_start_lam: Optional[bool] = None,
                 mesh_subcapsules: Optional[int] = None,
                 device="cuda"):
        # training default: Euler (see DPEnv); RK4 available for parity
        if integrator is None:
            integrator = EULER
        self.ENV_CFG = cfg or DPCombinedEnvConfig()
        self.robot = "unitree_g1"
        self.robot_config = RobotConfig(robot=self.robot)
        self.model = load_model(self.robot_config.xml_path)
        eng_kw = {k: v for k, v in dict(
            warm_start_lam=warm_start_lam,
            mesh_subcapsules=mesh_subcapsules).items() if v is not None}
        self.engine = Engine(self.model, max_contacts=max_contacts,
                             iterations=iterations, integrator=integrator,
                             device=device, **eng_kw)
        self.device = self.engine.device
        self.spec = RobotSpec.build(self.model, self.robot_config)
        self.reward_tables = reward_lib.make_reward_tables(self.model,
                                                           self.spec)
        self._reward_tables_dev = reward_lib.device_tables(
            self.reward_tables, self.device)
        self.getup_timeout_to_walk = getup_timeout_to_walk

        with tracing.setup("setup.mocap"):
            clips = {
                WALK: load_clip(MotionConfig("walk", self.robot).mocap_path,
                                self.model),
                RUN: load_clip(MotionConfig("run", self.robot).mocap_path,
                               self.model),
                GETUP: load_clip(MotionConfig("getup_facedown_towalk",
                                              self.robot).mocap_path,
                                 self.model),
            }
            lengths = [len(clips[WALK]), len(clips[RUN]), len(clips[GETUP]),
                       TO_GETUP_LEN]
            t_max = max(lengths)

            def padstack(field):
                rows = []
                for mid in (WALK, RUN, GETUP):
                    arr = getattr(clips[mid], field)
                    pad = np.repeat(arr[-1:], t_max - len(arr), axis=0)
                    rows.append(np.concatenate([arr, pad]))
                # TO_GETUP: constant target = getup clip frame 1
                const = getattr(clips[GETUP], field)[1]
                rows.append(np.repeat(const[None], t_max, axis=0))
                return torch.as_tensor(np.stack(rows), dtype=torch.float32,
                                       device=self.device)

            self.mocap_qpos = padstack("qpos")
            self.mocap_qvel = padstack("qvel")
            self.mocap_body_xpos = padstack("body_xpos")
            self.mocap_geom_xpos = padstack("geom_xpos")
            self.motion_lengths = torch.as_tensor(
                lengths, dtype=torch.int64, device=self.device)
        self.clips = clips
        self.lengths = tuple(lengths)
        self._pa_headings = torch.as_tensor(_PA_HEADINGS, device=self.device)
        self._body_mass = torch.as_tensor(
            np.asarray(self.model.body_mass), dtype=torch.float32,
            device=self.device)[:, None]

        self.action_size = self.model.nu - self.spec.n_hand_actions
        self.obs_size = obs_lib.obs_size(self.model, self.spec, self.ENV_CFG)
        self._graphs = StepGraphs(self)

    # ---- helpers --------------------------------------------------------
    def _mocap_at(self, motion_id, idx):
        return (self.mocap_qpos[motion_id, idx],
                self.mocap_qvel[motion_id, idx],
                self.mocap_body_xpos[motion_id, idx],
                self.mocap_geom_xpos[motion_id, idx])

    def _pa_obs(self, player_action):
        n_pa = self.ENV_CFG.MAX_PLAYER_ACTIONS
        onehot = (torch.arange(n_pa, device=self.device)[None]
                  == player_action[:, None]).to(torch.float32)
        return obs_lib.PlayerActionObs(
            onehot=onehot, heading_world=self._pa_headings[player_action])

    def _obs(self, data, qpos, qvel, motion_id, n_steps, player_action):
        mlen = self.motion_lengths[motion_id]
        idx = n_steps % mlen
        pa_getup_state = torch.stack([(motion_id == TO_GETUP),
                                      (motion_id == GETUP)], -1).to(
                                          torch.float32)
        return obs_lib.get_obs(self.model, self.spec, self.ENV_CFG, data,
                               qpos, qvel, idx, mlen,
                               player_action=self._pa_obs(player_action),
                               pa_getup_state=pa_getup_state)

    def _mujoco_action(self, action):
        ctrl = action * self.ENV_CFG.ACT_SCALE
        if self.spec.n_hand_actions:
            ctrl = torch.cat([ctrl, ctrl.new_zeros(
                ctrl.shape[0], self.spec.n_hand_actions)], -1)
        return ctrl

    # ---- on-policy handoff buffer ---------------------------------------
    def make_handoff_buffer(self, capacity: int = 4096) -> HandoffBuffer:
        nq, nv = self.model.nq, self.model.nv
        z = lambda *s, **k: torch.zeros(s, device=self.device, **k)
        return HandoffBuffer(
            qpos=z(capacity, nq), qvel=z(capacity, nv),
            pa=z(capacity, dtype=torch.int64),
            motion=torch.full((capacity,), RUN, dtype=torch.int64,
                              device=self.device),
            head=z(dtype=torch.int64), count=z(dtype=torch.int64))

    @staticmethod
    def handoff_capture_mask(prev_motion_id, out):
        """(B,) mask of envs that just exited GETUP into locomotion (and
        did not terminate on the same step)."""
        entered_loco = (out.motion_id == WALK) | (out.motion_id == RUN)
        return (prev_motion_id == GETUP) & entered_loco & ~out.done

    @staticmethod
    def update_handoff_buffer(buf: HandoffBuffer, mask, qpos, qvel, pa,
                              motion) -> HandoffBuffer:
        """Write the masked batch rows into the ring buffer in mask
        order, from ``head`` on; unmasked rows are dropped (the JAX
        package scatters them to index C, mode="drop"). ``head`` moves
        and ``count`` grows by the number of masked rows, ``count``
        capped at C.

        When one call captures more than C rows, the write positions
        wrap onto each other and the later row of each pair is the one
        kept: only the last C captured rows are written, so positions
        never repeat within a call and the result does not depend on the
        order of a parallel scatter. A row that is not kept goes to the
        drop row, like an unmasked one."""
        C = buf.qpos.shape[0]
        mask_i = mask.to(torch.int64)
        n_cap = mask_i.sum()
        offs = torch.cumsum(mask_i, 0) - 1
        keep = mask & (offs >= n_cap - C)
        pos = torch.where(keep, (buf.head + offs) % C, C)

        def put(dst, src):
            ext = torch.cat([dst, dst[:1]])     # row C is the drop row
            return ext.index_copy(0, pos, src.to(dst.dtype))[:C]

        return HandoffBuffer(
            qpos=put(buf.qpos, qpos), qvel=put(buf.qvel, qvel),
            pa=put(buf.pa, pa), motion=put(buf.motion, motion),
            head=(buf.head + n_cap) % C,
            count=torch.clamp(buf.count + n_cap, max=C))

    # ---- resets -----------------------------------------------------------
    def draw_reset(self, n: int, generator: Optional[torch.Generator],
                   handoff_buf: Optional[HandoffBuffer] = None
                   ) -> ResetDraws:
        """The random draws of ``n`` resets from ``generator``."""
        cfg = self.ENV_CFG
        dev = self.device
        rand = lambda: torch.rand(n, generator=generator, device=dev)
        randint = lambda hi: torch.randint(0, hi, (n,), generator=generator,
                                           device=dev)
        glen = self.lengths[GETUP]
        if handoff_buf is not None:
            # a row below count, drawn on the device (no host sync)
            cnt = torch.clamp(handoff_buf.count, min=1)
            buf_i = torch.minimum((rand() * cnt).to(torch.int64), cnt - 1)
        else:
            buf_i = torch.zeros(n, dtype=torch.int64, device=dev)
        return ResetDraws(
            pick_walk=rand() < 0.5,
            walk_r=randint(self.lengths[WALK]),
            getup_r=randint(glen),
            pick_handoff=rand() < cfg.HANDOFF_RSI_FRAC,
            handoff_r=randint(max(glen // 4, 1)),
            pick_fd=rand() < cfg.FACEDOWN_RSI_FRAC,
            pick_run=rand() < 0.5,
            use_buf=rand() < cfg.HANDOFF_BUFFER_FRAC,
            buf_i=buf_i)

    def _reset_state(self, n: int, generator=None,
                     handoff_buf: Optional[HandoffBuffer] = None,
                     draws: Optional[ResetDraws] = None, shard=None
                     ) -> CombinedEnvState:
        """50/50 walk (past the amnesty window) or getup at a random
        frame (reference: src/combined_env.py:208-244). Training-only
        extensions (cfg, default off): a HANDOFF_RSI_FRAC share of resets
        lands in the last quarter of the getup clip, a FACEDOWN_RSI_FRAC
        share at getup frame 0 with zero velocity, RSI_RANDOM_PA
        randomizes the commanded locomotion, and a HANDOFF_BUFFER_FRAC
        share starts from a state of the handoff buffer. With a
        ``shard``, the draws (generated or forced) are the global batch's
        and this rank keeps its ``n`` rows."""
        cfg = self.ENV_CFG
        d = draws if draws is not None else self.draw_reset(
            n * (shard.world if shard is not None else 1), generator,
            handoff_buf)
        if shard is not None:
            d = ResetDraws(*[shard.shard(x) for x in d])
        walk_steps = cfg.AMNESTY_STEPS + 10 + d.walk_r
        motion_id = torch.where(d.pick_walk, WALK, GETUP)
        n_steps = torch.where(d.pick_walk, walk_steps, d.getup_r)
        if cfg.HANDOFF_RSI_FRAC > 0.0:
            glen = self.lengths[GETUP]
            motion_id = torch.where(d.pick_handoff, GETUP, motion_id)
            n_steps = torch.where(d.pick_handoff, glen - 1 - d.handoff_r,
                                  n_steps)
        if cfg.FACEDOWN_RSI_FRAC > 0.0:
            motion_id = torch.where(d.pick_fd, GETUP, motion_id)
            n_steps = torch.where(d.pick_fd, 0, n_steps)
        pa = torch.full_like(motion_id, PA_WALK)
        if cfg.RSI_RANDOM_PA:
            pa = torch.where(d.pick_run, PA_RUN, PA_WALK)
        idx = n_steps % self.motion_lengths[motion_id]
        qpos, qvel, _, _ = self._mocap_at(motion_id, idx)
        if cfg.FACEDOWN_RSI_FRAC > 0.0:
            # the fall state is motionless: zero the clip velocity
            qvel = torch.where(d.pick_fd[:, None], 0.0, qvel)
        if handoff_buf is not None and cfg.HANDOFF_BUFFER_FRAC > 0.0:
            use = d.use_buf & (handoff_buf.count > 0)
            i = d.buf_i
            qpos = torch.where(use[:, None], handoff_buf.qpos[i], qpos)
            qvel = torch.where(use[:, None], handoff_buf.qvel[i], qvel)
            motion_id = torch.where(use, handoff_buf.motion[i], motion_id)
            pa = torch.where(use, handoff_buf.pa[i], pa)
            # the buffered state is the step AFTER the transition set
            # n_steps=0 (new_steps + 1), so resume the clip at frame 1
            n_steps = torch.where(use, 1, n_steps)
        return self._fresh_state(qpos, qvel, motion_id, n_steps, pa)

    def _fresh_state(self, qpos, qvel, motion_id, n_steps, pa
                     ) -> CombinedEnvState:
        n = qpos.shape[0]
        return CombinedEnvState(
            qpos=qpos, qvel=qvel, motion_id=motion_id, n_steps=n_steps,
            player_action=pa,
            episode_length=torch.zeros(n, dtype=torch.int64,
                                       device=self.device),
            episode_reward=torch.zeros(n, dtype=torch.float32,
                                       device=self.device),
            lam=self.engine.empty_lam(n))

    # ---- API --------------------------------------------------------------
    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None,
              draws: Optional[ResetDraws] = None, shard=None
              ) -> Tuple[CombinedEnvState, torch.Tensor]:
        return self._with_obs(self._reset_state(n_envs, generator,
                                                draws=draws, shard=shard))

    def reset_to(self, qpos, qvel, motion_id, n_steps, player_action
                 ) -> Tuple[CombinedEnvState, torch.Tensor]:
        """A fresh episode from a given state (each argument batched),
        e.g. a reset the JAX package recorded."""
        as_i = lambda x: torch.as_tensor(x, dtype=torch.int64,
                                         device=self.device)
        as_f = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                         device=self.device)
        return self._with_obs(self._fresh_state(
            as_f(qpos), as_f(qvel), as_i(motion_id), as_i(n_steps),
            as_i(player_action)))

    def _with_obs(self, state):
        data = self.engine.data_view(state.qpos, state.qvel)
        return state, self._obs(data, state.qpos, state.qvel,
                                state.motion_id, state.n_steps,
                                state.player_action)

    def step(self, state: CombinedEnvState, action: torch.Tensor,
             force_state=None) -> Tuple[CombinedEnvState, CombinedStepOut]:
        """One env step. ``force_state=(qpos, qvel)`` bypasses the
        dynamics: the fields are fresh at the forced state and ``lam``
        is the empty warm start, which the next physics step starts
        from."""
        with tracing.span("env.physics"):
            if force_state is not None:
                qpos, qvel = force_state
                data = self.engine.data_view(qpos, qvel)
            else:
                # stale-field semantics: see DPEnv.step
                ctrl = self._mujoco_action(action)
                qpos, qvel, data = self.engine.step(state.qpos, state.qvel,
                                                   ctrl, lam0=state.lam)
        return self._outcome(state, qpos, qvel, data)

    def _outcome(self, state: CombinedEnvState, qpos, qvel, data
                 ) -> Tuple[CombinedEnvState, CombinedStepOut]:
        """The step after the physics: obs, reward, transitions,
        termination, guards."""
        cfg = self.ENV_CFG
        motion_id = state.motion_id
        n_steps = state.n_steps
        mlen = self.motion_lengths[motion_id]
        idx = n_steps % mlen

        with tracing.span("env.obs"):
            obs = self._obs(data, qpos, qvel, motion_id, n_steps,
                            state.player_action)

        # ---- reward (src/combined_env.py:321-355) ----------------------
        with tracing.span("env.reward"):
            mq, mv, mb, mg = self._mocap_at(motion_id, idx)
            rew = reward_lib.calc_imitation_reward(
                self._reward_tables_dev, qpos, qvel, data.kin.geom_xpos,
                data.kin.xpos, mq, mv, mg, mb)
            is_locomotion = (motion_id == WALK) | (motion_id == RUN)
            is_to_getup = motion_id == TO_GETUP
            vel_err = torch.linalg.vector_norm(mv[:, :2] - qvel[:, :2],
                                               dim=-1)
            task_locomotion = torch.exp(-10.0 * vel_err)
            d_pitch = torch.abs(rew.curr_root_pitch - rew.target_root_pitch)
            d_roll = torch.abs(rew.curr_root_roll - rew.target_root_roll)
            config_error = (torch.abs(rew.config_angle_diffs).sum(-1)
                            + d_pitch + d_roll)
            task_getup = torch.exp(-config_error / 5.0) / 3.0
            imitation = torch.where(is_to_getup, 0.0, rew.reward)
            task = torch.where(is_locomotion, task_locomotion,
                               torch.where(is_to_getup, task_getup, 0.0))
            reward = 0.7 * imitation + 0.3 * task

        with tracing.span("env.done"):
            # ---- transitions (src/combined_env.py:398-445) ------------------
            # timer end (reference quirk: PAWalk()==PAWalk() is False -> RUN)
            out_of_time = n_steps >= (mlen - 1)
            getup_next = WALK if self.getup_timeout_to_walk else RUN
            new_motion = torch.where(out_of_time & (motion_id == GETUP),
                                     getup_next, motion_id)
            new_motion = torch.where(out_of_time & is_to_getup, GETUP,
                                     new_motion)

            # success: to_getup pose reached -> getup
            alim = float(np.deg2rad(np.float32(15.0)))
            is_success = ((torch.abs(rew.config_angle_diffs) < alim).all(-1)
                          & (d_pitch < alim) & (d_roll < alim))
            new_motion = torch.where(is_success & is_to_getup, GETUP,
                                     new_motion)

            # fallen (walk/run only)
            mass = self._body_mass
            z_com = ((data.kin.xipos * mass).sum(-2) / mass.sum())[:, 2]
            max_angle = float(np.deg2rad(np.float32(60.0)))
            fallen = ((z_com < self.spec.low_z) | (z_com > 2.0)
                      | (d_roll > max_angle) | (d_pitch > max_angle))
            fallen = fallen & is_locomotion
            no_amnesty = fallen & ~(n_steps > cfg.AMNESTY_STEPS)
            done = no_amnesty
            reason = torch.where(no_amnesty, DONE_FALLEN_NO_AMNESTY, 0)
            new_motion = torch.where(fallen, TO_GETUP, new_motion)

            changed = new_motion != motion_id
            new_steps = torch.where(changed, 0, n_steps)

            # max episode length
            over = state.episode_length >= cfg.MAX_EP_LENGTH
            reason = torch.where(over & ~done, DONE_MAX_EP_LEN, reason)
            done = done | over

            # obs guard (src/combined_env.py:474-485)
            bad = ((~torch.isfinite(obs).all(-1))
                   | (torch.abs(obs).amax(-1) > 100.0)
                   | (~torch.isfinite(qpos).all(-1))
                   | (~torch.isfinite(qvel).all(-1)))
            obs = torch.where(bad[:, None], 0.0, obs)
            reward = torch.where(bad, 0.0, reward)
            reason = torch.where(bad, DONE_OBS_OOB, reason)
            done = done | bad
            qpos = torch.where(torch.isfinite(qpos), qpos, 0.0)
            qvel = torch.where(torch.isfinite(qvel), qvel, 0.0)

        new_state = CombinedEnvState(
            qpos=qpos, qvel=qvel, motion_id=new_motion,
            n_steps=new_steps + 1, player_action=state.player_action,
            episode_length=state.episode_length + 1,
            episode_reward=state.episode_reward + reward, lam=data.lam)
        out = CombinedStepOut(
            obs=obs, reward=reward, done=done, done_reason=reason,
            imitation_reward=imitation, task_reward=task, reward_info=rew,
            motion_id=new_motion,
            contact_overflow=data.contacts.overflow)
        return new_state, out

    @tracing.spanned("env.step")
    def step_auto_reset(self, state: CombinedEnvState, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        handoff_buf: Optional[HandoffBuffer] = None,
                        draws: Optional[ResetDraws] = None, shard=None):
        """Training step: on done, the next state is a fresh reset drawn
        from ``generator`` (or ``draws``), from the handoff buffer where
        armed; the obs returned is the terminal obs. With a ``shard``,
        see ``_reset_state``.

        On a CUDA device with the Euler integrator the step is replayed
        as two CUDA graphs around the solve's call (``envs/graphs.py``);
        elsewhere it runs ``step_auto_reset_eager``. Both give the same
        step, and return tensors the caller owns."""
        return self._graphs.step(
            (state, action, handoff_buf, draws), generator, (shard,),
            lambda: self.step_auto_reset_eager(state, action, generator,
                                               handoff_buf, draws, shard))

    def step_auto_reset_eager(self, state: CombinedEnvState,
                              action: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              handoff_buf: Optional[HandoffBuffer] = None,
                              draws: Optional[ResetDraws] = None,
                              shard=None):
        """``step_auto_reset`` op by op, every stage in its span."""
        new_state, out = self.step(state, action)
        return self._auto_reset(new_state, out, generator, handoff_buf,
                                draws, shard)

    def _auto_reset(self, new_state, out, generator, handoff_buf, draws,
                    shard):
        with tracing.span("env.reset"):
            reset_state = self._reset_state(out.done.shape[0], generator,
                                            handoff_buf, draws, shard)
            d = out.done
            picked = CombinedEnvState(*[
                torch.where(d.view((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(reset_state, new_state)])
        return picked, out

    # the Euler step_auto_reset split at the solve, for envs/graphs.py
    def graph_pre(self, args):
        state, action = args[:2]
        with tracing.span("env.physics"):
            return self.engine.step_pre(state.qpos, state.qvel,
                                        self._mujoco_action(action),
                                        lam0=state.lam)

    def graph_post(self, args, extra, pre, res, generator):
        state, _, handoff_buf, draws = args
        with tracing.span("env.physics"):
            qpos, qvel, data = self.engine.step_post(state.qpos, state.qvel,
                                                     pre, res)
        new_state, out = self._outcome(state, qpos, qvel, data)
        return self._auto_reset(new_state, out, generator, handoff_buf,
                                draws, *extra)

    def get_current_motion_state(self, state: CombinedEnvState):
        """(qpos, qvel) of the current motion target (reference:
        src/combined_env.py:202-206)."""
        idx = state.n_steps % self.motion_lengths[state.motion_id]
        q, v, _, _ = self._mocap_at(state.motion_id, idx)
        return q, v
