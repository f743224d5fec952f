"""SAR substrate: geometry, simulator, filters, plan-compiled RDA / CSA /
omega-K pipelines, their multi-device lowering, metrics."""
from repro_torch.core.sar.geometry import (  # noqa: F401
    C,
    PointTarget,
    SceneConfig,
    paper_scene,
    paper_targets,
    scene_from_dict,
    test_scene,
)
from repro_torch.core.sar.simulate import simulate, simulate_cached  # noqa: F401
from repro_torch.core.sar.rda import (  # noqa: F401
    BUILDERS,
    Pipeline,
    Step,
    build_pipeline,
    documented_dispatches,
    focus,
    variant_names,
)
from repro_torch.core.sar import csa, filters, metrics, omegak  # noqa: F401
from repro_torch.core.sar import distributed  # noqa: F401
