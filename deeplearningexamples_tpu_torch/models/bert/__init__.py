from .modeling import (
    BERT_CONFIGS,
    BertConfig,
    BertForPreTraining,
    BertForQuestionAnswering,
    BertModel,
)
from .predict import predict_squad, write_predictions
from .task import BertPretrainTask, BertSquadTask
