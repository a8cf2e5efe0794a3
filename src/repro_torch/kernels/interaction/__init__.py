from .kernel import (DotInteraction, dot_interaction, dot_interaction_backward,
                     dot_interaction_cuda, dot_interaction_ref)

__all__ = ["DotInteraction", "dot_interaction", "dot_interaction_backward",
           "dot_interaction_cuda", "dot_interaction_ref"]
