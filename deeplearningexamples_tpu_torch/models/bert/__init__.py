from .modeling import (
    BERT_CONFIGS,
    BertConfig,
    BertForMultipleChoice,
    BertForPreTraining,
    BertForQuestionAnswering,
    BertForSequenceClassification,
    BertModel,
)
from .predict import predict_squad, read_squad_references, write_predictions
from .task import BertPretrainTask, BertSquadTask
