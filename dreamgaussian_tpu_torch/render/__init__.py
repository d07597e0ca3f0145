from .mesh_renderer import MeshRendererState, render_mesh, trunc_rev_sigmoid  # noqa: F401
