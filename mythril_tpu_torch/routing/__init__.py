"""The learned tier-ladder router + solver self-tuning flywheel.

Two loops over the training data the observe layer accumulates:

- **Cost-model router** (model.py / artifact.py / router.py): a
  dependency-free regularized linear model per route over the
  routing-JSONL v4 feature columns, predicting per-contract wall and
  success probability for each tier of the ladder.  Trained offline
  (``route train``), shipped as a versioned checksummed
  ``router-v<N>.json`` artifact with the compile plane's
  refusal-not-misload discipline, mounted at the three decision
  points that already see the features (corpus triage, serve
  admission, fleet replica choice) — and falling back to today's
  heuristics bit-for-bit whenever the artifact is absent, stale or
  refused.
- **Solver self-tuning** (tuning.py): ``solverlab tune --watch``
  incremental retuning over the accumulating ``--capture-queries``
  corpus, emitting versioned ``tuned-v<N>.json`` PORTFOLIO_DEFAULTS
  override artifacts that only promote after a 100% host-replay
  agreement gate.

Decisions, promotions, refusals and regret are all counted
(``mtpu_router_*`` — see docs/observability.md).

The port's copy of the JAX package's routing/. The trainer is host
numpy in the JAX order of operations, so one routing log trains a
byte-equal artifact (the same checksum) in both packages, and either
package loads the other's artifacts. The router mounts at two of the
JAX package's three decision points: the corpus triage
(analysis/corpus.py `analyze_corpus(router_dir=)`) and `serve`
admission (service/engine.py). The third, the fleet's replica choice,
waits for the fleet front, which the port does not have. A router that
raises while it loads or decides is recorded in the DegradationLog
(`router-failed`) at its call site, where the JAX package only logs
it; that call site keeps the built-in ladder, as in the JAX package."""

from __future__ import annotations

from mythril_tpu_torch.routing.artifact import (  # noqa: F401
    ROUTER_SCHEMA_VERSION,
    ArtifactRefused,
    latest_router,
    load_router_file,
    router_versions,
    save_router,
)
from mythril_tpu_torch.routing.model import (  # noqa: F401
    FEATURE_COLUMNS,
    TRAINABLE_ROUTES,
    feature_vector,
    normalize_route,
    train_model,
)
from mythril_tpu_torch.routing.router import (  # noqa: F401
    RouteDecision,
    Router,
    configure_router,
    configured_router,
    load_router,
)
from mythril_tpu_torch.routing.evaluate import (  # noqa: F401
    evaluate_log,
    explain_record,
)
from mythril_tpu_torch.routing.tuning import (  # noqa: F401
    TUNED_SCHEMA_VERSION,
    gate_overrides,
    latest_tuned,
    load_tuned_file,
    maybe_install_tuned,
    save_tuned,
)
