"""Cross-silo message protocol constants (the port's copy of
``fedml_tpu/cross_silo/message_define.py``, so wire traces of the two
packages compare)."""

MSG_TYPE_CONNECTION_IS_READY = 0
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
MSG_TYPE_C2S_CLIENT_TEST_INFO = 4
MSG_TYPE_C2S_CLIENT_STATUS = 5
MSG_TYPE_S2C_CHECK_CLIENT_STATUS = 6
MSG_TYPE_S2C_FINISH = 7
MSG_TYPE_C2S_FINISHED = 8

MSG_ARG_KEY_MODEL_PARAMS = "model_params"
# True when MODEL_PARAMS carries the delta vs the received global model
MSG_ARG_KEY_MODEL_IS_DELTA = "model_is_delta"
MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
MSG_ARG_KEY_CLIENT_STATUS = "client_status"
MSG_ARG_KEY_ROUND_INDEX = "round_idx"
MSG_ARG_KEY_CLIENT_OS = "client_os"
# the server's crash-recovery session epoch (absent without its journal)
MSG_ARG_KEY_SESSION_EPOCH = "session_epoch"
# upload idempotence key (absent without the client journal)
MSG_ARG_KEY_UPLOAD_KEY = "upload_key"
# hierarchical aggregation tree (absent in the flat protocol)
MSG_ARG_KEY_HIER_PARTIAL = "hier_partial"
MSG_ARG_KEY_HIER_CHILDREN = "hier_children"

CLIENT_STATUS_ONLINE = "ONLINE"
CLIENT_OS_PYTHON = "python"
