from nasrec_tpu_torch.search.tokenizer import Tokenizer
from nasrec_tpu_torch.search.evolution import Searcher, SearchConfig
from nasrec_tpu_torch.search.worker import (
    finetune_and_eval_candidates,
    make_candidate_evaluator,
)
