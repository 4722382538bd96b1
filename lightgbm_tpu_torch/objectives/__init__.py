from .objective import (ObjectiveFunction, create_objective,
                        parse_objective_from_model_string)

__all__ = ["ObjectiveFunction", "create_objective",
           "parse_objective_from_model_string"]
