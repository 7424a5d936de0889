"""Well-known label keys.

Mirrors the label surface the reference exposes on every instance type
(upstream ``pkg/providers/instancetype/types.go:67-122``) plus the core
karpenter.sh labels, renamed to this framework's domain where AWS-specific.
"""

# Kubernetes well-known
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
HOSTNAME = "kubernetes.io/hostname"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"

# Framework domain (reference: karpenter.sh / karpenter.k8s.aws)
GROUP = "karpenter.tpu"
PROVISIONER_NAME = f"{GROUP}/provisioner-name"
CAPACITY_TYPE = f"{GROUP}/capacity-type"  # reference: karpenter.sh/capacity-type
MANAGED_BY = f"{GROUP}/managed-by"
DO_NOT_EVICT_ANNOTATION = f"{GROUP}/do-not-evict"
DO_NOT_CONSOLIDATE_ANNOTATION = f"{GROUP}/do-not-consolidate"
VOLUNTARY_DISRUPTION_ANNOTATION = f"{GROUP}/voluntary-disruption"  # value: "drifted"
EMPTINESS_TIMESTAMP_ANNOTATION = f"{GROUP}/emptiness-timestamp"
LAUNCH_TEMPLATE_ANNOTATION = f"{GROUP}/launch-template"  # resolved config name
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Gang scheduling (all-or-nothing pod groups): members name their gang with
# the pod-group key as a LABEL or ANNOTATION (label preferred — it enters the
# scheduling signature through the label surface; the annotation form is the
# controller-friendly fallback and is folded into the signature explicitly by
# encode._signature). ``min-members`` rides an annotation on any member: the
# gang schedules only once at least that many members exist, and always as a
# unit — all pending members place in one round or none do.
POD_GROUP = f"{GROUP}/pod-group"
POD_GROUP_MIN_MEMBERS = f"{GROUP}/pod-group-min-members"

# TPU slice topology (solver/topology.py): a slice-capable offering carries
# its ICI-domain id (the "TPU pod" it draws chips from) and its torus
# coordinate inside that domain; nodes launched from it carry the same pair
# as LABELS, so nodeSelector pinning, the encoder's node surfaces and the
# flight-recorder capsules all see one vocabulary. SLICE_COORD values render
# as "x-y-z" (see topology.format_coord).
SLICE_POD = f"{GROUP}/slice-pod"
SLICE_COORD = f"{GROUP}/slice-coord"

# Per-pod slice-adjacency override (annotation): "required" forces the gang
# gate's adjacency replan to stand only when every member lands in ONE ICI
# domain, "none" opts the gang out of adjacency scoring entirely. Placement
# policy affects grouping (a carrier must never bucket with an otherwise
# identical plain pod), so encode._signature folds the value into the gang
# component and the native encoder defers carriers to Python, like gang
# members and spot-diversification carriers.
SLICE_ADJACENCY = f"{GROUP}/slice-adjacency"

# Multi-region eligibility (federation/): a comma-separated region list (or
# "*"/"any") on a pod — label or annotation — marking it eligible for
# cross-cluster routing by the federation arbiter. Absent means
# single-region: the federation gate never touches the pod. A gang's
# affinity is its name-sorted first annotated member's (the same
# deterministic first-member-wins convention gang_adjacency_mode uses).
REGION_AFFINITY = f"{GROUP}/region-affinity"
# Stamped (annotation) on every member of a gang re-entering the federation
# after its home region blacked out: the region the gang failed over FROM.
# Observability only — placement never reads it.
FAILOVER_FROM = f"{GROUP}/failover-from"
# Stamped (annotation) on every pod a federation transfer or failover moved
# across clusters: the lease's client token. The fleet's launch audit joins
# on it to prove no token is ever live in two clusters at once (the
# double-launch the epoch fence prevents). Placement never reads it.
FEDERATION_TOKEN = f"{GROUP}/federation-token"

# Per-pod spot-diversification override (annotation): a fraction in (0, 1]
# tightening/loosening settings.spot_diversification_max_frac for this pod's
# group, or "none" to opt the group out of the gate. Pool identity affects
# grouping: a carrier must never bucket with an otherwise-identical plain
# pod, so encode._signature folds the value in (and the native encoder
# defers carriers to Python, like gang members).
SPOT_DIVERSIFICATION = f"{GROUP}/spot-diversification-max-frac"

# Instance-type detail labels (reference: karpenter.k8s.aws/instance-*,
# types.go:67-122)
INSTANCE_GROUP = f"instance.{GROUP}"
INSTANCE_CATEGORY = f"{INSTANCE_GROUP}/instance-category"
INSTANCE_FAMILY = f"{INSTANCE_GROUP}/instance-family"
INSTANCE_GENERATION = f"{INSTANCE_GROUP}/instance-generation"
INSTANCE_SIZE = f"{INSTANCE_GROUP}/instance-size"
INSTANCE_CPU = f"{INSTANCE_GROUP}/instance-cpu"
INSTANCE_MEMORY = f"{INSTANCE_GROUP}/instance-memory"  # MiB
INSTANCE_NETWORK_BANDWIDTH = f"{INSTANCE_GROUP}/instance-network-bandwidth"  # Mbps
INSTANCE_PODS = f"{INSTANCE_GROUP}/instance-pods"
INSTANCE_GPU_NAME = f"{INSTANCE_GROUP}/instance-gpu-name"
INSTANCE_GPU_COUNT = f"{INSTANCE_GROUP}/instance-gpu-count"
INSTANCE_GPU_MEMORY = f"{INSTANCE_GROUP}/instance-gpu-memory"  # MiB
INSTANCE_ACCELERATOR_NAME = f"{INSTANCE_GROUP}/instance-accelerator-name"
INSTANCE_ACCELERATOR_COUNT = f"{INSTANCE_GROUP}/instance-accelerator-count"
INSTANCE_LOCAL_NVME = f"{INSTANCE_GROUP}/instance-local-nvme"  # GiB
INSTANCE_HYPERVISOR = f"{INSTANCE_GROUP}/instance-hypervisor"

# Capacity types (reference: v1alpha5.CapacityTypeSpot / OnDemand)
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# Keys that pods may not set via nodeSelector because the framework owns them.
RESTRICTED_LABELS = frozenset({PROVISIONER_NAME, MANAGED_BY})
