from repro_torch.core.access_patterns import (HOTNESS_LEVELS, PAPER_UNIQUE_PCT,
                                              AccessPattern, coverage_curve,
                                              hot_coverage, make_pattern,
                                              unique_access_pct)
from repro_torch.core.embedding import (EmbeddingBagCollection,
                                        EmbeddingStageConfig)
from repro_torch.core.hot_cache import (HotPlan, build_plan, identity_plan,
                                        l2_budget_rows, plan_from_trace,
                                        profile_counts)
from repro_torch.core.update import UpdateTxn, require_open
from repro_torch.core.plan import EmbeddingPlanReport, plan_embedding_stage
