"""Platform / optimizer / backend name constants.

Mirrors the role of the reference's ``python/fedml/constants.py`` (platform and
federated-optimizer string constants) so YAML recipes written against the
reference's ``fedml_config.yaml`` vocabulary keep working unchanged.
"""

# ---------------------------------------------------------------------------
# Training platforms (reference: constants.py FEDML_TRAINING_PLATFORM_*)
# ---------------------------------------------------------------------------
TRAINING_PLATFORM_SIMULATION = "simulation"
TRAINING_PLATFORM_CROSS_SILO = "cross_silo"
TRAINING_PLATFORM_CROSS_DEVICE = "cross_device"
TRAINING_PLATFORM_CROSS_CLOUD = "cross_cloud"
TRAINING_PLATFORM_SERVING = "model_serving"
TRAINING_PLATFORM_CENTRALIZED = "centralized"

# Simulation backends.  The reference dispatches on ``args.backend`` in
# ``simulation/simulator.py``; on TPU the native backend is the sharded
# single-controller program ("MESH").  "SP" is kept as the sequential
# single-device reference path (useful for numerics regression tests), and
# "MULTIPROCESS" maps to jax.distributed multi-host execution.
SIMULATION_BACKEND_SP = "sp"
SIMULATION_BACKEND_MESH = "MESH"  # TPU-native: clients sharded over mesh axis
SIMULATION_BACKEND_MPI = "MPI"  # accepted alias -> multiprocess jax.distributed
SIMULATION_BACKEND_NCCL = "NCCL"  # accepted alias -> MESH (collective-native)

# ---------------------------------------------------------------------------
# Federated optimizers (reference: FedML_FEDERATED_OPTIMIZER_*)
# ---------------------------------------------------------------------------
FEDERATED_OPTIMIZER_FEDAVG = "FedAvg"
FEDERATED_OPTIMIZER_FEDAVG_SEQ = "FedAvg_seq"
FEDERATED_OPTIMIZER_FEDOPT = "FedOpt"
FEDERATED_OPTIMIZER_FEDOPT_SEQ = "FedOpt_seq"
FEDERATED_OPTIMIZER_FEDPROX = "FedProx"
FEDERATED_OPTIMIZER_FEDNOVA = "FedNova"
FEDERATED_OPTIMIZER_FEDDYN = "FedDyn"
FEDERATED_OPTIMIZER_SCAFFOLD = "SCAFFOLD"
FEDERATED_OPTIMIZER_MIME = "Mime"
FEDERATED_OPTIMIZER_FEDSGD = "FedSGD"
FEDERATED_OPTIMIZER_ASYNC_FEDAVG = "Async_FedAvg"
FEDERATED_OPTIMIZER_FEDGAN = "FedGan"
FEDERATED_OPTIMIZER_HIERARCHICAL_FL = "HierarchicalFL"
FEDERATED_OPTIMIZER_TURBO_AGGREGATE = "TA"
FEDERATED_OPTIMIZER_DECENTRALIZED_FL = "decentralized_fl"
FEDERATED_OPTIMIZER_VERTICAL_FL = "vertical_fl"
FEDERATED_OPTIMIZER_SPLIT_NN = "split_nn"
FEDERATED_OPTIMIZER_FEDGKT = "FedGKT"
FEDERATED_OPTIMIZER_FEDNAS = "FedNAS"
FEDERATED_OPTIMIZER_FEDSEG = "FedSeg"
# federated LoRA finetuning (reference spotlight_prj/fedllm run_fedllm.py)
FEDERATED_OPTIMIZER_FEDLLM = "FedLLM"
# Fork research: CKA layer-selective personalized aggregation
# (my_research/.../MyAvgAPI_7.py; simulator.py:88-95 dispatches "MyAgg-*")
FEDERATED_OPTIMIZER_MYAVG = "MyAvg"
# only the -7 variant is implemented; MyAgg-4/5/6 differ materially in the
# reference (no CKA / no projection correction) and must not silently alias
FEDERATED_OPTIMIZER_MYAVG_ALIASES = ("MyAvg", "MyAgg-7")

# Communication backends (reference: fedml_comm_manager.py:133-207)
COMM_BACKEND_INPROC = "INPROC"  # loopback fake for tests (new; SURVEY.md §4)
COMM_BACKEND_GRPC = "GRPC"
COMM_BACKEND_MQTT_S3 = "MQTT_S3"
COMM_BACKEND_TCP = "TCP"  # polyglot frame transport (native/ C++ client)
COMM_BACKEND_TRPC = "TRPC"
COMM_BACKEND_MPI = "MPI"
COMM_BACKEND_WEB3 = "WEB3"  # messages as ledger transactions (comm/blockchain.py)
COMM_BACKEND_THETA = "THETASTORE"

# Device / engine
ENGINE_JAX = "jax"

# Dataset names understood by fedml_tpu.data.load (reference data_loader.py:262-530)
DATASETS_IMAGE = ("mnist", "femnist", "cifar10", "cifar100", "cinic10", "fashionmnist",
                  "gld23k", "gld160k")
DATASETS_TEXT = ("shakespeare", "fed_shakespeare", "stackoverflow_nwp", "reddit")
DATASETS_VECTOR = ("stackoverflow_lr", "lending_club")
DATASET_SYNTHETIC = "synthetic"

# Trust flags (reference runner.py:23): the security and privacy features a
# config can turn on
TRUST_FLAGS = ("enable_attack", "enable_defense", "enable_dp", "enable_secagg", "enable_fhe",
               "enable_contribution")
