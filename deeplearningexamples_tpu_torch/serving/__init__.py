from .batcher import ContinuousBatcher
from .binary import decode_tensors, encode_tensors
from .clients import http_infer, offline_performance_test, online_performance_test
from .export import load_model_repository, save_model_repository
from .server import InferenceServer, ModelEndpoint
