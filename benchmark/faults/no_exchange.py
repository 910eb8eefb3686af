"""The ranks of a data-parallel cell reduce nothing: each keeps its own
gradients and statistics."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.parallel.mesh import Mesh

    patch(Mesh, "all_reduce", lambda f: lambda self, x, op=None:
          x.clone())
