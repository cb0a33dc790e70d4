from .data import BaseDataset, Sequence, SequenceList
from .datasets import get_dataset
